"""Interprocedural analysis — the port's project source plane.

The counterpart of the JAX package's ``analysis/project.py``: the same
index, rules (DT005-DT009) and name-based call resolution, over the
port's ``core.py``, so the two planes find the same things in the same
source.

The per-file rules (rules_async.py) see one module at a time;
Dynamo's hardest bugs live *between* files — a task spawned in one
class and drained (or not) by another method, a lock held across an
await that bottoms out in a coordinator round-trip three calls away, a
KV-block stream left open on an exception path.  This pass builds a
project index in a first sweep (module symbol table + call graph +
task-spawn / lock / queue / stream-writer registries over every file)
and runs cross-module rules on top of the same registry / baseline /
noqa machinery:

  DT005  lock held across an await that transitively reaches a
         network/coordinator call (unbounded: not under wait_for)
  DT006  asyncio.Queue() created unbounded but fed from a network
         callback path (or a spawned pump task)
  DT007  stream/writer not closed on every exit path (close /
         wait_closed outside finally; transport teardown never awaited)
  DT008  task spawn site with no reachable cancel/drain on any
         shutdown-path method (close/stop/shutdown/drain/...)
  DT009  blocking file I/O reachable from an async function through a
         sync call chain (no asyncio.to_thread / run_in_executor) —
         the interprocedural complement of per-file DT003

Exposed as ``python -m dynamo_tpu_torch lint --project`` with the same
JSON / baseline / exit-code contract as the per-file pass.  Parsing is
shared with the per-file pass through core.parse_module, so running both
costs one ast.parse per file.

Like the per-file rules these are deliberately heuristic — tuned to this
codebase's idioms (retained-task sets drained in stop(), close_writer(),
write-locks that serialize exactly one write+drain) so the blessed
patterns pass untouched.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Optional, Sequence

from dynamo_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    _prescan,
    dotted_name,
    iter_python_files,
    parse_module,
)

__all__ = [
    "ProjectIndex",
    "ProjectRule",
    "project_rules",
    "lint_project",
]

_SPAWN_NAMES = {"asyncio.ensure_future", "asyncio.create_task"}
_SPAWN_ATTRS = {"ensure_future", "create_task"}

# calls that ARE the network: dials, listeners, HTTP clients
NET_PRIMITIVE_CALLS = {
    "asyncio.open_connection",
    "asyncio.start_server",
    "socket.create_connection",
    "aiohttp.ClientSession",
}
# awaiting one of these attr calls means waiting on a peer's bytes
NET_READER_ATTRS = {"readexactly", "readuntil"}
# codebase-tuned seeds: RPCs that await a response future the call graph
# cannot see through (the read loop resolves it on a different task)
KNOWN_ROUNDTRIP_SUFFIXES = ("CoordinatorClient._call",)

# ultra-generic method names excluded from by-name call-graph resolution
# (dict.get / Queue.put / StreamWriter.drain would otherwise alias every
# same-named project function and poison reachability)
GENERIC_ATTRS = frozenset({
    "get", "put", "put_nowait", "get_nowait", "pop", "add", "append",
    "appendleft", "popleft", "discard", "remove", "update", "close",
    "wait_closed", "drain", "write", "read", "readline", "send", "recv",
    "start", "stop", "run", "join", "cancel", "set", "clear", "acquire",
    "release", "flush", "sleep", "gather", "result", "done", "values",
    "items", "keys", "open", "wait", "setdefault", "extend", "copy",
    "encode", "decode", "format", "split", "strip", "sort",
    # step: engine loop / decode-stream / policy all expose one;
    # __init__: obj.__init__() would alias every constructor in the tree
    "step", "__init__",
})

# blocking file-I/O primitives (DT009 sinks): dotted calls that open or
# flush a file, plus the pathlib whole-file convenience methods (attr
# calls).  `.open()` the attr is deliberately absent — too many non-file
# objects expose an open() method (stores, pools, devices).
FILE_IO_CALLS = frozenset({"open", "io.open", "os.fsync"})
FILE_IO_ATTRS = frozenset({
    "read_bytes", "write_bytes", "read_text", "write_text",
})

SHUTDOWN_METHOD_NAMES = frozenset({
    "close", "stop", "shutdown", "aclose", "drain", "drain_all",
    "stop_all", "abort", "disconnect", "cleanup", "terminate",
    "unregister", "__aexit__", "__exit__", "close_when_idle",
})


# ------------------------------------------------------------- index model ----


@dataclass
class CallSite:
    kind: str        # "dotted" (import-resolved) | "self" | "attr"
    name: str        # canonical dotted name, method name, or attr name
    node: ast.Call = field(repr=False, default=None)


@dataclass
class FunctionInfo:
    qualname: str                    # "pkg.mod.Class.method" (or nested)
    module: str
    cls: Optional[str]               # owning class qualname, or None
    name: str
    node: ast.AST = field(repr=False, default=None)
    is_async: bool = False
    calls: list[CallSite] = field(default_factory=list)
    # names N such that the function contains N.put(...) / N.put_nowait(...)
    put_targets: set[str] = field(default_factory=set)
    lock_locals: set[str] = field(default_factory=set)


@dataclass
class ClassInfo:
    qualname: str
    module: str
    node: ast.AST = field(repr=False, default=None)
    methods: dict[str, FunctionInfo] = field(default_factory=dict)
    lock_attrs: set[str] = field(default_factory=set)


@dataclass
class QueueSite:
    fn: FunctionInfo
    node: ast.Call
    target: Optional[str]            # binding name ("q", "merged") if any
    has_maxsize: bool


@dataclass
class WriterBinding:
    fn: FunctionInfo
    node: ast.AST                    # the open_connection assignment
    kind: str                        # "local" | "attr"
    writer: str                      # local name or self-attribute name


@dataclass
class HandlerReg:
    fn: FunctionInfo                 # function containing start_server(...)
    node: ast.Call
    handler: str                     # method name (self.X) or module function


@dataclass
class SpawnSite:
    fn: FunctionInfo
    node: ast.Call
    attr: Optional[str]              # self-attribute the handle lands in


# ---------------------------------------------------------------- the index ----


class ProjectIndex:
    """Whole-project facts: symbol table, call graph, and the spawn /
    lock / queue / writer registries the cross-module rules key off."""

    def __init__(self) -> None:
        self.modules: dict[str, ModuleContext] = {}       # modname -> ctx
        self.ctx_by_path: dict[str, ModuleContext] = {}   # rel path -> ctx
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.by_name: dict[str, list[FunctionInfo]] = {}
        self.queue_sites: list[QueueSite] = []
        self.writer_bindings: list[WriterBinding] = []
        self.handler_regs: list[HandlerReg] = []
        self.spawn_sites: list[SpawnSite] = []
        self._net: Optional[set[str]] = None

    # ------------------------------------------------------------- building
    @classmethod
    def build(cls, files: Sequence[Path], root: Optional[Path] = None) -> "ProjectIndex":
        index = cls()
        for path in files:
            path = Path(path)
            rel = path
            if root is not None:
                try:
                    rel = path.resolve().relative_to(Path(root).resolve())
                except ValueError:
                    rel = path
            try:
                source, tree = parse_module(path)
            except (SyntaxError, OSError):
                continue  # the per-file pass reports DT000 for these
            relpos = rel.as_posix()
            modname = relpos[:-3].replace("/", ".")
            if modname.endswith(".__init__"):
                modname = modname[: -len(".__init__")]
            ctx = ModuleContext(relpos, source, tree)
            # reuse the per-file pre-scan's import table logic
            _prescan(ctx)
            index.modules[modname] = ctx
            index.ctx_by_path[relpos] = ctx
            _IndexWalker(index, ctx, modname).walk()
        return index

    # ------------------------------------------------------------ call graph
    def resolve(self, site: CallSite, fn: FunctionInfo) -> list[FunctionInfo]:
        """Candidate FunctionInfos a call site may target."""
        if site.kind == "dotted":
            hit = self.functions.get(site.name)
            if hit is None and "." not in site.name:
                # module-local call: `foo()` in mod -> "mod.foo"
                hit = self.functions.get(f"{fn.module}.{site.name}")
            return [hit] if hit else []
        if site.kind == "self" and fn.cls:
            ci = self.classes.get(fn.cls)
            if ci and site.name in ci.methods:
                return [ci.methods[site.name]]
            return []
        if site.kind == "attr" and site.name not in GENERIC_ATTRS:
            return self.by_name.get(site.name, [])
        return []

    def _is_net_sink(self, fn: FunctionInfo) -> bool:
        if fn.qualname.endswith(KNOWN_ROUNDTRIP_SUFFIXES):
            return True
        for site in fn.calls:
            if site.kind == "dotted" and site.name in NET_PRIMITIVE_CALLS:
                return True
            if site.kind == "attr" and site.name in NET_READER_ATTRS:
                return True
        return False

    @property
    def net(self) -> set[str]:
        """Qualnames of functions that transitively reach the network
        (dial, listen, await peer bytes, coordinator RPC)."""
        if self._net is not None:
            return self._net
        net = {q for q, f in self.functions.items() if self._is_net_sink(f)}
        # reverse-propagate to callers until fixpoint
        changed = True
        while changed:
            changed = False
            for q, f in self.functions.items():
                if q in net:
                    continue
                for site in f.calls:
                    if any(t.qualname in net for t in self.resolve(site, f)):
                        net.add(q)
                        changed = True
                        break
        self._net = net
        return net

    def network_callee(self, call: ast.Call, fn: FunctionInfo) -> Optional[str]:
        """If ``call`` (transitively) reaches the network, a short
        human-readable description of the sink edge; else None."""
        raw = dotted_name(call.func)
        ctx = self.modules.get(fn.module)
        canon = ctx.canonical(raw) if ctx and raw else raw
        if canon in NET_PRIMITIVE_CALLS:
            return canon
        site = _classify_call(call, ctx)
        if site is None:
            return None
        if site.kind == "attr" and site.name in NET_READER_ATTRS:
            return f".{site.name}() (awaiting peer bytes)"
        for target in self.resolve(site, fn):
            if target.qualname in self.net:
                return f"{site.name}() -> {_short(target.qualname)}"
        return None

    def is_lock_expr(self, expr: ast.AST, fn: FunctionInfo) -> bool:
        raw = dotted_name(expr)
        if not raw:
            return False
        leaf = raw.rsplit(".", 1)[-1]
        if raw.startswith("self.") and fn.cls:
            ci = self.classes.get(fn.cls)
            if ci and raw.split(".", 1)[1] in ci.lock_attrs:
                return True
        if leaf in fn.lock_locals:
            return True
        return "lock" in leaf.lower()


def _short(qualname: str) -> str:
    parts = qualname.split(".")
    return ".".join(parts[-2:]) if len(parts) > 1 else qualname


def _classify_call(node: ast.Call, ctx: Optional[ModuleContext]) -> Optional[CallSite]:
    raw = dotted_name(node.func)
    if not raw:
        return None
    if raw.startswith("self."):
        rest = raw.split(".", 1)[1]
        if "." not in rest:
            return CallSite("self", rest, node)
        return CallSite("attr", rest.rsplit(".", 1)[-1], node)
    head = raw.split(".", 1)[0]
    if ctx is not None and (head in ctx.imports or "." not in raw):
        canon = ctx.canonical(raw)
        # only resolvable (imported or module-level) names are "dotted";
        # a bare unknown name stays unresolved
        if head in ctx.imports or canon != raw or "." in canon:
            return CallSite("dotted", canon, node)
        return CallSite("dotted", canon, node)
    if isinstance(node.func, ast.Attribute):
        return CallSite("attr", node.func.attr, node)
    return CallSite("dotted", raw, node)


# ------------------------------------------------------------- index walker ----


class _IndexWalker:
    """One recursive pass per module: records functions, classes, call
    sites, and the rule registries, and links parents
    (``node._dt_pparent``) for ancestry queries."""

    def __init__(self, index: ProjectIndex, ctx: ModuleContext, modname: str):
        self.index = index
        self.ctx = ctx
        self.modname = modname
        self.class_stack: list[ClassInfo] = []
        self.func_stack: list[FunctionInfo] = []

    def walk(self) -> None:
        self._visit(self.ctx.tree, None)

    # ------------------------------------------------------------- helpers
    def _qual(self, name: str) -> str:
        parts = [self.modname]
        parts += [c.qualname.rsplit(".", 1)[-1] for c in self.class_stack]
        parts += [f.name for f in self.func_stack]
        parts.append(name)
        return ".".join(parts)

    @property
    def fn(self) -> Optional[FunctionInfo]:
        return self.func_stack[-1] if self.func_stack else None

    def _visit(self, node: ast.AST, parent: Optional[ast.AST]) -> None:
        node._dt_pparent = parent  # type: ignore[attr-defined]

        if isinstance(node, ast.ClassDef):
            ci = ClassInfo(self._qual(node.name), self.modname, node)
            self.index.classes[ci.qualname] = ci
            self.class_stack.append(ci)
            for child in ast.iter_child_nodes(node):
                self._visit(child, node)
            self.class_stack.pop()
            return

        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fi = FunctionInfo(
                qualname=self._qual(node.name),
                module=self.modname,
                cls=self.class_stack[-1].qualname if self.class_stack else None,
                name=node.name,
                node=node,
                is_async=isinstance(node, ast.AsyncFunctionDef),
            )
            self.index.functions[fi.qualname] = fi
            self.index.by_name.setdefault(node.name, []).append(fi)
            if self.class_stack and not self.func_stack:
                self.class_stack[-1].methods[node.name] = fi
            self.func_stack.append(fi)
            for child in ast.iter_child_nodes(node):
                self._visit(child, node)
            self.func_stack.pop()
            return

        if isinstance(node, ast.Assign):
            self._record_assign(node)
        elif isinstance(node, ast.Call):
            self._record_call(node)

        for child in ast.iter_child_nodes(node):
            self._visit(child, node)

    def _record_assign(self, node: ast.Assign) -> None:
        value = node.value
        call = value.value if isinstance(value, ast.Await) else value
        if not isinstance(call, ast.Call):
            return
        canon = self.ctx.canonical(dotted_name(call.func))
        targets = node.targets
        if canon == "asyncio.Lock":
            for tgt in targets:
                raw = dotted_name(tgt)
                if raw.startswith("self.") and self.class_stack:
                    self.class_stack[-1].lock_attrs.add(raw.split(".", 1)[1])
                elif isinstance(tgt, ast.Name) and self.fn:
                    self.fn.lock_locals.add(tgt.id)
        elif canon == "asyncio.open_connection" and self.fn:
            for tgt in targets:
                if isinstance(tgt, ast.Tuple) and len(tgt.elts) == 2:
                    w = tgt.elts[1]
                    raw = dotted_name(w)
                    if raw.startswith("self.") and "." not in raw[5:]:
                        self.index.writer_bindings.append(
                            WriterBinding(self.fn, node, "attr", raw[5:])
                        )
                    elif isinstance(w, ast.Name):
                        self.index.writer_bindings.append(
                            WriterBinding(self.fn, node, "local", w.id)
                        )

    def _record_call(self, node: ast.Call) -> None:
        fn = self.fn
        ctx = self.ctx
        raw = dotted_name(node.func)
        canon = ctx.canonical(raw) if raw else ""
        if fn is not None:
            site = _classify_call(node, ctx)
            if site is not None:
                fn.calls.append(site)
            # put-target registry (DT006 feeders)
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "put", "put_nowait",
            ):
                base = dotted_name(node.func.value)
                if base:
                    fn.put_targets.add(base.rsplit(".", 1)[-1])
            # queue creations
            if canon == "asyncio.Queue":
                has_max = bool(node.args) or any(
                    kw.arg == "maxsize" for kw in node.keywords
                )
                self.index.queue_sites.append(
                    QueueSite(fn, node, _binding_name(node), has_max)
                )
            # spawn sites (handle destination resolved lazily by DT008)
            is_spawn = canon in _SPAWN_NAMES or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SPAWN_ATTRS
            )
            if is_spawn:
                self.index.spawn_sites.append(
                    SpawnSite(fn, node, attr=None)
                )
        # start_server handler registrations (also at module level)
        if canon == "asyncio.start_server" and node.args and fn is not None:
            h = dotted_name(node.args[0])
            if h.startswith("self."):
                h = h.split(".", 1)[1]
            if h and "." not in h:
                self.index.handler_regs.append(HandlerReg(fn, node, h))


def _binding_name(call: ast.Call) -> Optional[str]:
    """The name an expression is bound to, via parent links:
    ``q = asyncio.Queue()`` / ``q: asyncio.Queue = asyncio.Queue()``."""
    parent = getattr(call, "_dt_pparent", None)
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
        tgt = parent.targets[0]
    elif isinstance(parent, ast.AnnAssign):
        tgt = parent.target
    else:
        return None
    raw = dotted_name(tgt)
    return raw.rsplit(".", 1)[-1] if raw else None


# -------------------------------------------------------- ancestry helpers ----


def _parents(node: ast.AST) -> Iterator[ast.AST]:
    node = getattr(node, "_dt_pparent", None)
    while node is not None:
        yield node
        node = getattr(node, "_dt_pparent", None)


def _enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    for p in _parents(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return p
    return None


def _walk_within(func_node: ast.AST, types) -> Iterator[ast.AST]:
    """ast.walk restricted to nodes whose nearest enclosing function is
    ``func_node`` (nested defs are their own FunctionInfo)."""
    for sub in ast.walk(func_node):
        if isinstance(sub, types) and _enclosing_function(sub) is func_node:
            yield sub


def _in_finally(node: ast.AST) -> bool:
    child = node
    for p in _parents(node):
        if isinstance(p, ast.Try):
            for stmt in p.finalbody:
                if child is stmt or any(child is d for d in ast.walk(stmt)):
                    return True
        child = p
    return False


def _is_bounded_await(awaitnode: ast.Await, ctx: ModuleContext) -> bool:
    """await asyncio.wait_for(...) — the round-trip is bounded."""
    v = awaitnode.value
    if isinstance(v, ast.Call):
        return ctx.canonical(dotted_name(v.func)) == "asyncio.wait_for"
    return False


def _awaited_calls(awaitnode: ast.Await, ctx: ModuleContext) -> list[ast.Call]:
    """The call(s) an await resolves to: the awaited call itself, or the
    arguments of a gather/wait/shield wrapper."""
    v = awaitnode.value
    if not isinstance(v, ast.Call):
        return []
    canon = ctx.canonical(dotted_name(v.func))
    if canon in ("asyncio.gather", "asyncio.wait", "asyncio.shield"):
        out = []
        for a in v.args:
            a = a.value if isinstance(a, ast.Starred) else a
            if isinstance(a, ast.Call):
                out.append(a)
        return out
    return [v]


# ------------------------------------------------------------ project rules ----


class ProjectRule(Rule):
    """A rule that checks the whole index rather than one module."""

    def check(self, index: ProjectIndex) -> Iterable[Finding]:
        return ()

    def finding(self, ctx: ModuleContext, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            path=ctx.path,
            line=line,
            col=getattr(node, "col_offset", 0),
            rule=self.code,
            message=message,
            snippet=ctx.line_text(line),
        )


_PROJECT_REGISTRY: dict[str, type[ProjectRule]] = {}


def register_project(cls: type[ProjectRule]) -> type[ProjectRule]:
    _PROJECT_REGISTRY[cls.code] = cls
    return cls


def project_rules(select: Optional[Sequence[str]] = None) -> list[ProjectRule]:
    codes = sorted(_PROJECT_REGISTRY)
    if select:
        wanted = {c.strip().upper() for c in select}
        codes = [c for c in codes if c in wanted]
    return [_PROJECT_REGISTRY[c]() for c in codes]


@register_project
class LockHeldAcrossNetwork(ProjectRule):
    """DT005 — a lock held across an await that transitively reaches a
    network/coordinator call, unbounded.  If the peer wedges, every
    other acquirer queues behind the dead round-trip: a drain can't
    finish, shutdown hangs, keepalives stall.  Release the lock before
    awaiting, or bound the await with ``asyncio.wait_for``.  Locks that
    serialize exactly one local write+drain are fine (drain is local
    backpressure, not a round-trip)."""

    code = "DT005"
    name = "lock-held-across-network"
    summary = (
        "lock held across an unbounded await that transitively reaches "
        "a network/coordinator call"
    )

    def check(self, index: ProjectIndex) -> Iterable[Finding]:
        for fn in index.functions.values():
            if not fn.is_async:
                continue
            ctx = index.modules[fn.module]
            for aw in _walk_within(fn.node, ast.AsyncWith):
                if not any(
                    index.is_lock_expr(item.context_expr, fn)
                    for item in aw.items
                ):
                    continue
                for awaitnode in ast.walk(aw):
                    if not isinstance(awaitnode, ast.Await):
                        continue
                    if _enclosing_function(awaitnode) is not fn.node:
                        continue
                    if _is_bounded_await(awaitnode, ctx):
                        continue
                    for call in _awaited_calls(awaitnode, ctx):
                        desc = index.network_callee(call, fn)
                        if desc:
                            yield self.finding(
                                ctx, aw,
                                "lock held across an unbounded await that "
                                f"reaches the network ({desc}) — release "
                                "the lock before awaiting, or bound the "
                                "round-trip with asyncio.wait_for",
                            )
                            break
                    else:
                        continue
                    break  # one finding per async-with


@register_project
class UnboundedNetworkFedQueue(ProjectRule):
    """DT006 — ``asyncio.Queue()`` created unbounded but fed from a
    network callback path (a read loop, or a pump task spawned to drain
    a stream).  A slow consumer turns the queue into an unbounded
    buffer of peer-controlled data — an OOM with extra steps.  Give it
    a ``maxsize`` (the feeder's ``await put()`` then provides real
    backpressure) or justify the unboundedness."""

    code = "DT006"
    name = "unbounded-network-fed-queue"
    summary = (
        "unbounded asyncio.Queue fed from a network callback / pump task"
    )

    def check(self, index: ProjectIndex) -> Iterable[Finding]:
        for qs in index.queue_sites:
            if qs.has_maxsize or not qs.target:
                continue
            ctx = index.modules[qs.fn.module]
            feeders = [
                f for f in index.functions.values()
                if f.module == qs.fn.module and qs.target in f.put_targets
            ]
            why = None
            for f in feeders:
                if f.qualname in index.net:
                    why = f"fed by network-path {_short(f.qualname)}()"
                    break
                if self._is_spawned_pump(f, qs.fn, index):
                    why = f"fed by spawned pump task {f.name}()"
                    break
            if why:
                yield self.finding(
                    ctx, qs.node,
                    f"unbounded asyncio.Queue {qs.target!r} {why} — give "
                    "it a maxsize so a slow consumer applies backpressure "
                    "instead of buffering without bound",
                )

    @staticmethod
    def _is_spawned_pump(f: FunctionInfo, creator: FunctionInfo,
                         index: ProjectIndex) -> bool:
        """``f`` is a function nested in ``creator`` whose invocation is
        handed to ensure_future/create_task (the pump-task idiom)."""
        if not f.qualname.startswith(creator.qualname + "."):
            return False
        for sp in index.spawn_sites:
            if sp.fn.qualname != creator.qualname or not sp.node.args:
                continue
            arg = sp.node.args[0]
            if isinstance(arg, ast.Call) and dotted_name(arg.func) == f.name:
                return True
        return False


@register_project
class StreamNotClosedOnExit(ProjectRule):
    """DT007 — a stream/writer without a guaranteed close on every exit
    path.  Three shapes: a local writer from ``open_connection`` whose
    ``close()`` is not in a ``finally``; a class-owned writer
    (``self._writer``) the class never closes — or closes without ever
    awaiting ``wait_closed()`` (the transport teardown is never awaited,
    so tests and shutdown leak live TCP transports); and a
    ``start_server`` handler that doesn't close its writer in a
    ``finally``.  ``framing.close_writer()`` is the blessed helper
    (close + bounded wait_closed)."""

    code = "DT007"
    name = "stream-not-closed-on-exit"
    summary = (
        "stream/writer not closed on every exit path (close/wait_closed "
        "missing or outside finally)"
    )

    def check(self, index: ProjectIndex) -> Iterable[Finding]:
        seen_attr: set[tuple[str, str]] = set()
        for wb in index.writer_bindings:
            ctx = index.modules[wb.fn.module]
            if wb.kind == "local":
                yield from self._check_local(index, ctx, wb)
            else:
                key = (wb.fn.cls or wb.fn.module, wb.writer)
                if key in seen_attr:
                    continue
                seen_attr.add(key)
                yield from self._check_attr(index, ctx, wb)
        for reg in index.handler_regs:
            yield from self._check_handler(index, reg)

    # -- a local writer must be closed in a finally (or escape ownership)
    def _check_local(self, index, ctx, wb: WriterBinding):
        fn = wb.fn
        w = wb.writer
        closes, escapes = [], False
        for sub in _walk_within(fn.node, ast.AST):
            if isinstance(sub, ast.Call):
                f = sub.func
                if (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == w
                    and f.attr in ("close", "wait_closed", "abort")
                ):
                    closes.append(sub)
                    continue
                if dotted_name(f).endswith("close_writer") and any(
                    isinstance(a, ast.Name) and a.id == w for a in sub.args
                ):
                    closes.append(sub)
                    continue
                # writer handed to another call: ownership escapes
                for a in sub.args:
                    if isinstance(a, ast.Name) and a.id == w:
                        escapes = True
            elif isinstance(sub, (ast.Return, ast.Yield)):
                for n in ast.walk(sub):
                    if isinstance(n, ast.Name) and n.id == w:
                        escapes = True
            elif isinstance(sub, ast.Assign):
                raw = dotted_name(sub.targets[0]) if sub.targets else ""
                if raw.startswith("self.") and any(
                    isinstance(n, ast.Name) and n.id == w
                    for n in ast.walk(sub.value)
                ):
                    escapes = True
        if escapes:
            return
        if not closes:
            yield self.finding(
                ctx, wb.node,
                f"writer {w!r} from open_connection is never closed in "
                "this function and never escapes — close it (use "
                "framing.close_writer) in a finally",
            )
        elif not any(_in_finally(c) for c in closes):
            yield self.finding(
                ctx, wb.node,
                f"writer {w!r} from open_connection is closed only on "
                "the happy path — move close()/wait_closed() (or "
                "framing.close_writer) into a finally so exception "
                "paths don't leak the transport",
            )

    # -- a class-owned writer: some method must close it, and teardown
    #    must be awaited at least once (wait_closed or close_writer)
    def _check_attr(self, index, ctx, wb: WriterBinding):
        if wb.fn.cls is None:
            return
        attr = wb.writer
        closed = awaited = False
        for f in index.functions.values():
            if f.cls != wb.fn.cls:
                continue
            for sub in ast.walk(f.node):
                if not isinstance(sub, ast.Call):
                    continue
                fun = sub.func
                raw = dotted_name(fun)
                if raw == f"self.{attr}.close" or raw == f"self.{attr}.abort":
                    closed = True
                elif raw == f"self.{attr}.wait_closed":
                    awaited = True
                elif raw.endswith("close_writer") and any(
                    dotted_name(a) == f"self.{attr}" for a in sub.args
                ):
                    closed = awaited = True
        cls_name = _short(wb.fn.cls)
        if not closed:
            yield self.finding(
                ctx, wb.node,
                f"transport self.{attr} opened here is never closed by "
                f"any method of {cls_name} — close it on the shutdown "
                "path (framing.close_writer)",
            )
        elif not awaited:
            yield self.finding(
                ctx, wb.node,
                f"{cls_name} closes self.{attr} but never awaits "
                "wait_closed(): the transport teardown is never awaited "
                "and shutdown leaks live TCP transports — use "
                "framing.close_writer",
            )

    # -- a server handler owns its writer: close in a finally
    def _check_handler(self, index, reg: HandlerReg):
        candidates = []
        if reg.fn.cls:
            ci = index.classes.get(reg.fn.cls)
            if ci and reg.handler in ci.methods:
                candidates = [ci.methods[reg.handler]]
        if not candidates:
            candidates = [
                f for f in index.by_name.get(reg.handler, [])
                if f.module == reg.fn.module
            ]
        for h in candidates:
            args = h.node.args.args
            params = [a.arg for a in args if a.arg != "self"]
            if len(params) < 2:
                continue
            w = params[1]
            ctx = index.modules[h.module]
            closes = [
                sub for sub in _walk_within(h.node, ast.Call)
                if (
                    isinstance(sub.func, ast.Attribute)
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id == w
                    and sub.func.attr in ("close", "abort")
                )
                or (
                    dotted_name(sub.func).endswith("close_writer")
                    and any(
                        isinstance(a, ast.Name) and a.id == w
                        for a in sub.args
                    )
                )
            ]
            if not closes or not any(_in_finally(c) for c in closes):
                yield self.finding(
                    ctx, h.node,
                    f"server handler {h.name}() must close its writer "
                    f"{w!r} in a finally — a raising request path leaks "
                    "the connection",
                )


@register_project
class SpawnWithoutShutdownDrain(ProjectRule):
    """DT008 — a task spawned into instance state with no reachable
    cancel/drain on any shutdown-path method.  The task outlives its
    owner: at loop teardown it is destroyed pending (exception lost), in
    tests it leaks into the next test, in production a drained worker
    keeps a zombie loop alive.  The blessed idiom: retain the handle,
    cancel (and await) it from close()/stop()/shutdown()."""

    code = "DT008"
    name = "spawn-without-shutdown-drain"
    summary = (
        "task spawned into self.<attr> with no cancel/drain reachable "
        "from any shutdown-path method"
    )

    def check(self, index: ProjectIndex) -> Iterable[Finding]:
        for sp in index.spawn_sites:
            fn = sp.fn
            if fn.cls is None:
                continue
            attr = self._handle_attr(sp)
            if attr is None:
                continue
            ci = index.classes.get(fn.cls)
            if ci is None:
                continue
            if not self._drained(index, ci, attr):
                ctx = index.modules[fn.module]
                yield self.finding(
                    ctx, sp.node,
                    f"task spawned into self.{attr} has no reachable "
                    "cancel/drain on any shutdown-path method "
                    f"({'/'.join(sorted(SHUTDOWN_METHOD_NAMES)[:4])}/...) "
                    f"of {_short(fn.cls)} — cancel and await it on close",
                )

    # ---- where does the handle land?
    @staticmethod
    def _handle_attr(sp: SpawnSite) -> Optional[str]:
        node = sp.node
        parent = getattr(node, "_dt_pparent", None)
        # self._tasks.add(spawn(...)) / self._tasks.append(spawn(...))
        if isinstance(parent, ast.Call) and isinstance(parent.func, ast.Attribute):
            if parent.func.attr in ("add", "append", "appendleft"):
                base = dotted_name(parent.func.value)
                if base.startswith("self."):
                    return base.split(".", 1)[1].split(".")[0]
        stmt = parent
        while stmt is not None and not isinstance(stmt, ast.stmt):
            stmt = getattr(stmt, "_dt_pparent", None)
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            return None
        tgt = stmt.targets[0]
        raw = dotted_name(tgt)
        if raw.startswith("self."):
            return raw.split(".", 1)[1].split(".")[0]
        if isinstance(tgt, ast.Subscript):
            base = dotted_name(tgt.value)
            if base.startswith("self."):
                return base.split(".", 1)[1].split(".")[0]
        if isinstance(tgt, ast.Name):
            # local handle: follow one hop of add/append/subscript/pack
            return SpawnWithoutShutdownDrain._local_to_attr(sp, tgt.id)
        return None

    @staticmethod
    def _local_to_attr(sp: SpawnSite, local: str) -> Optional[str]:
        names = {local}
        fn_node = sp.fn.node
        # one aliasing hop: entry = (conn, task); x = task
        for sub in _walk_within(fn_node, ast.Assign):
            if any(
                isinstance(n, ast.Name) and n.id in names
                for n in ast.walk(sub.value)
            ):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
        for sub in _walk_within(fn_node, ast.AST):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
                if sub.func.attr in ("add", "append", "appendleft") and any(
                    isinstance(a, ast.Name) and a.id in names
                    for a in sub.args
                ):
                    base = dotted_name(sub.func.value)
                    if base.startswith("self."):
                        return base.split(".", 1)[1].split(".")[0]
            elif isinstance(sub, ast.Assign) and sub.targets:
                tgt = sub.targets[0]
                if isinstance(tgt, ast.Subscript) and any(
                    isinstance(n, ast.Name) and n.id in names
                    for n in ast.walk(sub.value)
                ):
                    base = dotted_name(tgt.value)
                    if base.startswith("self."):
                        return base.split(".", 1)[1].split(".")[0]
        return None

    # ---- is the attr cancelled/drained from a shutdown-path method?
    @staticmethod
    def _shutdown_methods(index: ProjectIndex, ci: ClassInfo) -> list[FunctionInfo]:
        roots = [
            m for n, m in ci.methods.items() if n in SHUTDOWN_METHOD_NAMES
        ]
        out, queue = {m.qualname: m for m in roots}, list(roots)
        while queue:
            m = queue.pop()
            for site in m.calls:
                if site.kind == "self" and site.name in ci.methods:
                    callee = ci.methods[site.name]
                    if callee.qualname not in out:
                        out[callee.qualname] = callee
                        queue.append(callee)
        return list(out.values())

    @classmethod
    def _drained(cls, index: ProjectIndex, ci: ClassInfo, attr: str) -> bool:
        dotted = f"self.{attr}"
        for m in cls._shutdown_methods(index, ci):
            loop_vars: set[str] = set()
            for sub in ast.walk(m.node):
                if isinstance(sub, ast.Call):
                    raw = dotted_name(sub.func)
                    # self.A.cancel()  (incl. guarded `if self.A:`)
                    if raw.startswith(dotted + ".") and raw.rsplit(".", 1)[-1] in (
                        "cancel", "join",
                    ):
                        return True
                    # gather(*self.A) / wait(self.A) / wait_for(self.A)
                    if raw in ("asyncio.gather", "asyncio.wait",
                               "asyncio.wait_for"):
                        for a in sub.args:
                            inner = a.value if isinstance(a, ast.Starred) else a
                            if dotted in _dotted_names(inner):
                                return True
                elif isinstance(sub, ast.Await):
                    # await self.A  — awaiting the handle drains it
                    if dotted_name(sub.value) == dotted:
                        return True
                elif isinstance(sub, (ast.For, ast.AsyncFor)):
                    # for t in (list(self.A) | self.A.values() | self.A):
                    if dotted in _dotted_names(sub.iter):
                        for n in ast.walk(sub.target):
                            if isinstance(n, ast.Name):
                                loop_vars.add(n.id)
            if loop_vars:
                for sub in ast.walk(m.node):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ("cancel", "join")
                        and isinstance(sub.func.value, ast.Name)
                        and sub.func.value.id in loop_vars
                    ):
                        return True
        return False


@register_project
class BlockingFileIoFromAsync(ProjectRule):
    """DT009 — blocking file I/O reachable from an async function
    through a sync call chain.  The per-file pass (DT003) catches
    ``open()`` written directly inside an ``async def``; it cannot see
    an ``open()`` hiding one sync call away — the event loop stalls just
    the same (a slow disk or an fsync under a busy page cache holds
    every connection sharing the loop).  The fix is the coordinator's
    blob-I/O idiom: push the sync helper through ``asyncio.to_thread``
    or ``run_in_executor``.  Handing the helper to an executor passes it
    as an *argument*, not a call, so the blessed pattern creates no
    call edge and discharges naturally.  Async callees are not carriers:
    awaiting one suspends rather than blocks, and direct I/O in an
    async body is DT003's finding, not ours."""

    code = "DT009"
    name = "blocking-file-io-from-async"
    summary = (
        "async function calls a sync helper that performs blocking file "
        "I/O (open/read/write/fsync) without to_thread/run_in_executor"
    )

    @staticmethod
    def _direct_io(fn: FunctionInfo) -> Optional[str]:
        for site in fn.calls:
            if site.kind == "dotted" and site.name in FILE_IO_CALLS:
                return f"{site.name}()"
            if site.kind in ("attr", "self") and site.name in FILE_IO_ATTRS:
                return f".{site.name}()"
        return None

    def _io_reachers(self, index: ProjectIndex) -> dict[str, str]:
        """qualname -> leaf-sink description, for sync functions that do
        (or transitively reach, through sync calls only) blocking file
        I/O — the same reverse fixpoint as ProjectIndex.net."""
        io: dict[str, str] = {}
        for q, f in index.functions.items():
            if f.is_async:
                continue
            desc = self._direct_io(f)
            if desc:
                io[q] = desc
        changed = True
        while changed:
            changed = False
            for q, f in index.functions.items():
                if f.is_async or q in io:
                    continue
                for site in f.calls:
                    hit = next(
                        (t for t in index.resolve(site, f)
                         if not t.is_async and t.qualname in io),
                        None,
                    )
                    if hit is not None:
                        io[q] = io[hit.qualname]
                        changed = True
                        break
        return io

    def check(self, index: ProjectIndex) -> Iterable[Finding]:
        io = self._io_reachers(index)
        for fn in index.functions.values():
            if not fn.is_async:
                continue
            ctx = index.modules[fn.module]
            reported: set[str] = set()
            for site in fn.calls:
                for target in index.resolve(site, fn):
                    if target.is_async or target.qualname not in io:
                        continue
                    if target.qualname in reported:
                        continue
                    reported.add(target.qualname)
                    yield self.finding(
                        ctx, site.node,
                        f"async {fn.name}() calls "
                        f"{_short(target.qualname)}() which does blocking "
                        f"file I/O ({io[target.qualname]}) on the event "
                        "loop — wrap the call in asyncio.to_thread or "
                        "run_in_executor",
                    )


def _dotted_names(node: ast.AST) -> set[str]:
    return {dotted_name(n) for n in ast.walk(node)
            if isinstance(n, (ast.Attribute, ast.Name))} - {""}


# ----------------------------------------------------------------- driver ----


def lint_project(
    paths: Sequence[Path],
    rules: Optional[Sequence[ProjectRule]] = None,
    root: Optional[Path] = None,
    index: Optional[ProjectIndex] = None,
) -> list[Finding]:
    """Build the project index over ``paths`` and run the
    interprocedural rules; same Finding/noqa/sort contract as
    core.lint_paths."""
    rules = list(rules) if rules is not None else project_rules()
    if index is None:
        files = list(iter_python_files([Path(p) for p in paths]))
        index = ProjectIndex.build(files, root=root)
    findings: list[Finding] = []
    for rule in rules:
        findings.extend(rule.check(index))
    out = []
    for f in findings:
        ctx = index.ctx_by_path.get(f.path)
        if ctx is not None and ctx.is_suppressed(f):
            continue
        out.append(f)
    return sorted(set(out))
