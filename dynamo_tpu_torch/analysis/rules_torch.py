"""PyTorch/CUDA rules (DT101-DT105) for the port's hot path.

The counterpart of ``dynamo_tpu/analysis/rules_jax.py``, as ``ops/kernels/``
is of ``ops/pallas/``: the same five codes, read for eager PyTorch and the
hand-written kernels.  They encode the discipline the port's step functions
follow: load a kernel library and build a CUDA graph once, read a dispatch's
results back in one copy per step (``EngineCore._read``), write the KV cache
in place, keep tensors off ``self`` inside a step function, and launch a
kernel only through its wrapper, with the geometry the kernel plane audits
(``ops/kernels/registry.py``, ``csrc/launch_geometry.cuh``).
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from dynamo_tpu_torch.analysis.core import Finding, ModuleContext, Rule, dotted_name, register

# what loads a native library or captures a graph: built once, reused
_LOADERS = frozenset({
    "ctypes.CDLL",
    "ctypes.PyDLL",
    "ctypes.cdll.LoadLibrary",
    "torch.ops.load_library",
    "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline",
    "torch.cuda.CUDAGraph",
})
_CACHING_DECORATORS = frozenset({"functools.lru_cache", "functools.cache", "lru_cache", "cache"})


def _stmt_of(node: ast.AST) -> Optional[ast.stmt]:
    while node is not None and not isinstance(node, ast.stmt):
        node = getattr(node, "_dt_parent", None)
    return node


def _assigned(stmt: ast.AST) -> list[ast.AST]:
    if isinstance(stmt, ast.Assign):
        return list(stmt.targets)
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        return [stmt.target]
    return []


def _decorators(func: ast.AST, ctx: ModuleContext) -> set[str]:
    out = set()
    for d in getattr(func, "decorator_list", ()):
        out.add(ctx.canonical(dotted_name(d.func if isinstance(d, ast.Call) else d)))
    return out


def _in_path(ctx: ModuleContext, *parts: str) -> bool:
    path = "/" + ctx.path
    return any(f"/{p}/" in path for p in parts)


@register
class LibraryPerCall(Rule):
    """DT101 — a kernel library load, a ``ctypes.CDLL`` or a
    ``torch.cuda.CUDAGraph()`` built per call.  Loading the library (or
    building it) per launch costs milliseconds of ``dlopen`` and symbol
    binding on the per-token path, and a graph captured per call pays the
    capture every step instead of replaying it.  Build it once: at module or
    ``__init__`` scope, cached on an attribute, in a module global the
    function declares, or behind ``functools.lru_cache``."""

    code = "DT101"
    name = "library-or-graph-per-call"
    summary = (
        "kernel library load, ctypes.CDLL or torch.cuda.CUDAGraph() built per call; build "
        "it once and cache it"
    )
    interests = (ast.Call,)

    def visit(self, node: ast.Call, ctx: ModuleContext) -> Iterable[Finding]:
        fn = ctx.call_name(node)
        if fn not in _LOADERS:
            return
        what = fn.rsplit(".", 1)[-1]
        parent = getattr(node, "_dt_parent", None)
        if isinstance(parent, (ast.Attribute, ast.Call)) and getattr(parent, "value",
                                                                     getattr(parent, "func", None)) is node:
            yield ctx.finding(self, node, f"{what}(...) used at once: a fresh one per call; "
                              "build it once and keep it")
            return
        if ctx.loop_depth > 0:
            yield ctx.finding(self, node, f"{what}(...) inside a loop: built every iteration; "
                              "hoist it out of the loop")
            return
        func = ctx.current_func
        if func is None or func.name == "__init__":
            return  # module, class or init scope: built once
        if _decorators(func, ctx) & _CACHING_DECORATORS:
            return
        if any(isinstance(n, ast.Global) for n in ast.walk(func)):
            return  # kept in a module global the function owns
        stmt = _stmt_of(node)
        if any("." in dotted_name(t) for t in _assigned(stmt)):
            return  # cached on an attribute
        yield ctx.finding(self, node, f"{what}(...) built inside {func.name}() without being "
                          "cached: one per call; hoist it to module or __init__ scope, or cache it")


# the host reads of a device tensor: each waits for the card
_HOST_READS = frozenset({"item", "tolist", "cpu", "numpy"})


@register
class HostSyncInLoop(Rule):
    """DT102 — a host read inside a loop on the hot path (``engine/``,
    ``models/``): ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` or
    ``torch.cuda.synchronize()``.  On a device tensor each one waits for the
    card and drains the stream, so the host stops enqueuing the next work;
    and a CUDA graph cannot contain one.  Read a step's results back in ONE
    copy (``EngineCore._read``: the packed results of a whole burst).  On a
    host array the call is harmless: baseline it with that justification."""

    code = "DT102"
    name = "host-sync-in-loop"
    summary = (
        "per-iteration .item()/.tolist()/.cpu()/.numpy()/torch.cuda.synchronize() on the hot "
        "path: read a step's results back in one copy"
    )
    interests = (ast.Call,)

    def visit(self, node: ast.Call, ctx: ModuleContext) -> Iterable[Finding]:
        if ctx.loop_depth <= 0 or not _in_path(ctx, "engine", "models"):
            return
        fn = ctx.call_name(node)
        if fn == "torch.cuda.synchronize":
            what = "torch.cuda.synchronize()"
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_READS \
                and not node.args:
            what = f".{node.func.attr}()"
        else:
            return
        yield ctx.finding(self, node, f"{what} inside a loop: one host round trip per iteration "
                          "on a device tensor; read the step's results back once")


# what makes a new tensor from an old one
_COPIES = frozenset({"torch.cat", "torch.stack", "torch.clone", "torch.concat"})
_COPY_METHODS = frozenset({"clone", "to", "contiguous"})


def _copy_call(node: ast.AST, ctx: ModuleContext) -> Optional[str]:
    """The name of the first copying call in ``node``'s tree, if any."""
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        fn = ctx.call_name(n)
        if fn in _COPIES:
            return fn
        if isinstance(n.func, ast.Attribute) and n.func.attr in _COPY_METHODS:
            return f".{n.func.attr}()"
    return None


def _copy_of_cache(node: ast.AST, ctx: ModuleContext) -> Optional[str]:
    """The copying call ``node`` is, when it copies a cache: a method of a
    name holding ``cache`` (``cache.clone()``), or ``torch.cat``/``stack``/
    ``clone`` with such a name among its direct arguments."""
    if not isinstance(node, ast.Call):
        return None

    def names_cache(n: ast.AST) -> bool:
        return "cache" in dotted_name(n).rsplit(".", 1)[-1]

    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _COPY_METHODS and names_cache(f.value):
        return f".{f.attr}()"
    fn = ctx.call_name(node)
    if fn in _COPIES:
        args = [e for a in node.args for e in (a.elts if isinstance(a, (ast.List, ast.Tuple))
                                               else [a])]
        if any(names_cache(a) for a in args):
            return fn
    return None


def _step_function(func: Optional[ast.AST], ctx: ModuleContext) -> bool:
    """A dispatch's device function: a ``*_step`` or ``_impl`` function, or
    one run under ``torch.no_grad`` / ``torch.inference_mode``."""
    if func is None:
        return False
    if func.name.endswith("_step") or func.name == "_impl":
        return True
    return bool(_decorators(func, ctx) & {"torch.no_grad", "torch.inference_mode"})


@register
class CacheReboundOutOfPlace(Rule):
    """DT103 — the KV cache rebound out of place: ``self.cache = ...`` or a
    step's returned cache made from ``torch.cat``, ``clone``, ``.to(...)``
    or ``.contiguous()``.  The cache is the card's largest tensor; a step
    that makes a new one copies all of it (a whole HBM pass a step, and twice
    its memory at the peak) where the port's contract is one tensor written
    in place (the JAX package's donated buffer).  Write the rows in place
    (``index_put_``, ``index_copy_``, a kernel); the compile plane's TR004
    checks the same on the walk."""

    code = "DT103"
    name = "cache-rebound-out-of-place"
    summary = "KV cache rebuilt by cat/clone/.to()/.contiguous() instead of written in place"
    interests = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Return)

    def visit(self, node: ast.AST, ctx: ModuleContext) -> Iterable[Finding]:
        if isinstance(node, ast.Return):
            if node.value is None or not _step_function(ctx.current_func, ctx):
                return
            parts = node.value.elts if isinstance(node.value, ast.Tuple) else [node.value]
            for part in parts:
                how = _copy_of_cache(part, ctx)
                if how:
                    yield ctx.finding(self, part, f"{ctx.current_func.name}() returns its cache "
                                      f"made by {how}: a full copy a step; write the cache in "
                                      "place and return it as it is")
                    return
            return
        value = getattr(node, "value", None)
        if value is None:
            return
        for t in _assigned(node):
            if isinstance(t, ast.Attribute) and t.attr == "cache":
                how = _copy_call(value, ctx)
                if how:
                    yield ctx.finding(self, node, f"{dotted_name(t) or 'cache'} rebound to a tensor "
                                      f"made by {how}: the cache is copied, not written in place")
                    return


@register
class TensorOnSelf(Rule):
    """DT104 — an attribute stored on ``self`` inside a step function (a
    ``*_step`` or ``_impl`` method, or one run under ``torch.no_grad``).  A
    tensor kept on the instance by a dispatch outlives it: it pins device
    memory the caching allocator cannot reuse, and a CUDA graph captured
    from the dispatch would bake its address into the replay.  Return the
    value and let the host-side caller keep what it needs."""

    code = "DT104"
    name = "tensor-on-self"
    summary = "attribute store on self inside a step function (a tensor outliving its dispatch)"
    interests = (ast.Assign, ast.AugAssign, ast.AnnAssign)

    def visit(self, node: ast.AST, ctx: ModuleContext) -> Iterable[Finding]:
        func = ctx.current_func
        if not _step_function(func, ctx):
            return
        for t in _assigned(node):
            for el in ast.walk(t):
                if isinstance(el, ast.Attribute) and isinstance(el.value, ast.Name) \
                        and el.value.id in ("self", "cls"):
                    yield ctx.finding(self, node, f"store to {el.value.id}.{el.attr} inside step "
                                      f"function {func.name}(): the value outlives the dispatch; "
                                      "return it and store it in the caller")
                    return


def _library_call(node: ast.Call, scope: ast.AST) -> bool:
    """Whether ``node`` calls a ``dynamo_*`` symbol of the kernel library:
    on ``<x>.library()`` itself, or on a name ``scope`` binds to it."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr.startswith("dynamo_")):
        return False

    def is_library(call: ast.AST) -> bool:
        return isinstance(call, ast.Call) and dotted_name(call.func).rsplit(".", 1)[-1] == "library"

    recv = f.value
    if isinstance(recv, ast.Name):
        return any(isinstance(n, ast.Assign) and is_library(n.value) and
                   any(isinstance(t, ast.Name) and t.id == recv.id for t in n.targets)
                   for n in ast.walk(scope))
    return is_library(recv)


def _int_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, int) \
        and not isinstance(node.value, bool) and node.value > 1


@register
class KernelGeometryBypass(Rule):
    """DT105 — a kernel launched around its wrapper or its audited geometry.
    The kernel plane (``lint --kern``) audits every kernel's launch budgets,
    plans and padding through ``ops/kernels/registry.py``, and the wrappers
    in ``ops/kernels/*.py`` check device, dtype, shape and contiguity and
    count launches.  Three shapes:

    * a ``dynamo_*`` symbol of the kernel library called outside
      ``ops/kernels/``: a launch the wrapper's checks, its counter and the
      audit never see;
    * an integer literal > 1 among a library symbol's arguments: launch
      geometry written at the call instead of taken from the plan (whose
      numbers come from ``csrc/launch_geometry.cuh``, which the registry
      reads);
    * an integer-literal default > 1 on a ``*_per_*`` parameter of a module
      that launches a kernel: the default is the served geometry, so it
      must be a registry name.
    """

    code = "DT105"
    name = "kernel-geometry-bypass"
    summary = (
        "kernel library symbol called outside its ops/kernels wrapper, or launch geometry "
        "written as a literal instead of taken from ops/kernels/registry.py"
    )
    interests = (ast.Module,)

    def visit(self, node: ast.Module, ctx: ModuleContext) -> Iterable[Finding]:
        found: dict[int, ast.Call] = {}
        scopes = [n for n in ast.walk(node) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes + [node]:
            for call in ast.walk(scope):
                if isinstance(call, ast.Call) and id(call) not in found and \
                        _library_call(call, scope):
                    found[id(call)] = call
        if not found:
            return
        launches = sorted(found.values(), key=lambda c: (c.lineno, c.col_offset))
        wrapper = "/ops/kernels/" in "/" + ctx.path
        for call in launches:
            sym = call.func.attr
            if not wrapper:
                yield ctx.finding(self, call, f"{sym}() launched outside its ops/kernels wrapper: "
                                  "no device/shape checks, no launch count, no kernel-plane "
                                  "audit; call the wrapper")
            for arg in call.args:
                if _int_literal(arg):
                    yield ctx.finding(self, arg, f"integer literal {arg.value} passed to {sym}(): "
                                      "launch geometry written at the call escapes the kernel "
                                      "plane; take it from the plan (ops/kernels/registry.py)")
        for fn in ast.walk(node):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = list(fn.args.posonlyargs) + list(fn.args.args)
                pairs = list(zip(args[len(args) - len(fn.args.defaults):], fn.args.defaults))
                pairs += [(a, d) for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults)
                          if d is not None]
                for arg, default in pairs:
                    if "_per_" in arg.arg and _int_literal(default):
                        yield ctx.finding(self, default, f"{fn.name}({arg.arg}={default.value}): "
                                          "the default is the served geometry; bind it to a "
                                          "registry name")
