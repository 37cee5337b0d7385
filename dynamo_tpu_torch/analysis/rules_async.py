"""Async-safety rules (DT001–DT004) for the distributed runtime.

The counterpart of the JAX package's ``analysis/rules_async.py``: the same
four rules, over the port's ``core.py``.

These target the control-plane failure modes that dominate production
incidents in disaggregated serving stacks (PAPERS.md FlowKV; a
swallowed-cancellation bug once found by hand in workers.py): leaked fire-and-forget
tasks, silently eaten errors, event-loop stalls, and FIRST_COMPLETED
waiter leaks.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from dynamo_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    dotted_name,
    register,
)

# canonical dotted names that spawn a task
_SPAWN_NAMES = {"asyncio.ensure_future", "asyncio.create_task"}

_BROAD_EXC = {"Exception", "BaseException"}

# logging-ish attribute names: a handler calling one of these is not
# silently eating the error
_LOG_METHODS = {
    "debug", "info", "warning", "error", "exception", "critical", "log",
    "print_exc",
}

# canonical dotted names of calls that block the event loop
_BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.Popen",
    "os.system",
    "os.popen",
    "os.waitpid",
    "socket.create_connection",
    "urllib.request.urlopen",
    "requests.get",
    "requests.post",
    "requests.put",
    "requests.delete",
    "requests.head",
    "requests.request",
    "open",
}


def _stmt_of(node: ast.AST) -> Optional[ast.AST]:
    """Innermost statement containing ``node`` (via walker parent links)."""
    while node is not None and not isinstance(node, ast.stmt):
        node = getattr(node, "_dt_parent", None)
    return node


@register
class FireAndForgetTask(Rule):
    """DT001 — ``asyncio.ensure_future``/``create_task`` whose handle is
    discarded.  An unreferenced task can be garbage-collected mid-flight,
    and its exception is silently dropped at loop shutdown; the runtime
    has been bitten by exactly this (coordinator watcher notifies).  Store
    the handle (retain + done-callback, drain on close) or await it."""

    code = "DT001"
    name = "fire-and-forget-task"
    summary = (
        "task handle from ensure_future/create_task is never stored, "
        "awaited, or cancelled"
    )
    interests = (ast.Call,)

    def visit(self, node: ast.Call, ctx: ModuleContext) -> Iterable[Finding]:
        fn = ctx.call_name(node)
        if fn not in _SPAWN_NAMES and not fn.endswith(".create_task"):
            return
        parent = getattr(node, "_dt_parent", None)
        # a bare expression statement discards the handle; anything else
        # (assignment, await, return, argument, attribute access) keeps
        # or consumes it
        if isinstance(parent, ast.Expr):
            yield ctx.finding(
                self, node,
                f"fire-and-forget task from {fn.rsplit('.', 1)[-1]}(): "
                "handle is never stored, awaited, or cancelled — retain it "
                "(set + done-callback that logs exceptions) and drain it "
                "on shutdown",
            )


@register
class SilentBroadExcept(Rule):
    """DT002 — broad ``except Exception``/bare ``except`` inside ``async
    def`` that neither logs nor re-raises.  In an async loop this eats
    transport faults invisibly: the stream just stops and nobody can
    diagnose why.  Log with ``exc_info=True`` (debug level is fine) or
    narrow the exception type."""

    code = "DT002"
    name = "silent-broad-except"
    summary = (
        "broad except in async code swallows the error without logging"
    )
    interests = (ast.ExceptHandler,)

    def _is_broad(self, handler: ast.ExceptHandler, ctx: ModuleContext) -> bool:
        t = handler.type
        if t is None:
            return True
        types = t.elts if isinstance(t, ast.Tuple) else [t]
        return any(
            ctx.canonical(dotted_name(el)) in _BROAD_EXC for el in types
        )

    def _handles_error(self, handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and fn.attr in _LOG_METHODS:
                    return True
                if isinstance(fn, ast.Name) and fn.id in ("print",):
                    return True
                name = dotted_name(fn)
                if name.startswith("warnings.warn"):
                    return True
        return False

    def visit(
        self, node: ast.ExceptHandler, ctx: ModuleContext
    ) -> Iterable[Finding]:
        if not ctx.in_async:
            return
        if not self._is_broad(node, ctx):
            return
        if self._handles_error(node):
            return
        yield ctx.finding(
            self, node,
            "broad except inside async def silently eats the error — "
            "add log.debug(..., exc_info=True) or narrow the exception "
            "type",
        )


@register
class BlockingCallInAsync(Rule):
    """DT003 — blocking calls (``time.sleep``, sync subprocess/socket/
    file IO) directly on the event loop.  One blocked loop stalls every
    connection sharing it — keepalives miss TTLs, leases expire, watchers
    false-delete live workers.  Use the asyncio equivalent or push the
    call through ``run_in_executor`` (the coordinator's fsync/blob IO
    shows the pattern)."""

    code = "DT003"
    name = "blocking-call-in-async"
    summary = "blocking call inside async def stalls the event loop"
    interests = (ast.Call,)

    def visit(self, node: ast.Call, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.in_async:
            return
        fn = ctx.call_name(node)
        if fn not in _BLOCKING_CALLS:
            return
        yield ctx.finding(
            self, node,
            f"blocking call {fn}() inside async def stalls the event "
            "loop — use the asyncio equivalent or run_in_executor",
        )


@register
class FirstCompletedLoserLeak(Rule):
    """DT004 — ``asyncio.wait(..., FIRST_COMPLETED)`` whose losing
    waiters are never cancelled.  The loser keeps running (and holding
    its queue/stream slot) after the winner returns; over a long stream
    that's a task-per-token leak.  tcp.py's generate loop and
    async_engine's cancel race show the correct shape: cancel the loser
    in every exit path."""

    code = "DT004"
    name = "first-completed-loser-leak"
    summary = (
        "asyncio.wait(FIRST_COMPLETED) without cancelling the losing "
        "waiters"
    )
    interests = (ast.Call,)

    def _is_first_completed(self, node: ast.Call, ctx: ModuleContext) -> bool:
        if ctx.call_name(node) != "asyncio.wait":
            return False
        for kw in node.keywords:
            if kw.arg == "return_when":
                name = ctx.canonical(dotted_name(kw.value))
                if name.endswith("FIRST_COMPLETED"):
                    return True
                if (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value == "FIRST_COMPLETED"
                ):
                    return True
        return False

    def _candidates(self, node: ast.Call) -> set[str]:
        """Names whose cancellation discharges the finding: the waited
        task names, the pending-set unpack target, and loop vars
        iterating either."""
        names: set[str] = set()
        if node.args:
            arg0 = node.args[0]
            if isinstance(arg0, (ast.List, ast.Set, ast.Tuple)):
                for el in arg0.elts:
                    if isinstance(el, ast.Name):
                        names.add(el.id)
            elif isinstance(arg0, ast.Name):
                names.add(arg0.id)
        # done, pending = await asyncio.wait(...)
        stmt = _stmt_of(node)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt = stmt.targets[0]
            if isinstance(tgt, ast.Tuple) and len(tgt.elts) == 2:
                pend = tgt.elts[1]
                if isinstance(pend, ast.Name):
                    names.add(pend.id)
        return names

    def visit(self, node: ast.Call, ctx: ModuleContext) -> Iterable[Finding]:
        if not self._is_first_completed(node, ctx):
            return
        func = ctx.current_func
        if func is None:
            return
        candidates = self._candidates(node)
        # extend candidates with loop vars over any candidate
        # (for t in pending: t.cancel()), then look for a discharge:
        # .cancel() on a candidate, or gather/wait over it (awaiting the
        # losers is also a non-leak)
        for sub in ast.walk(func):
            if isinstance(sub, (ast.For, ast.AsyncFor)):
                if (
                    isinstance(sub.iter, ast.Name)
                    and sub.iter.id in candidates
                    and isinstance(sub.target, ast.Name)
                ):
                    candidates.add(sub.target.id)
        for sub in ast.walk(func):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr == "cancel"
                and isinstance(fn.value, ast.Name)
                and fn.value.id in candidates
            ):
                return
            if ctx.call_name(sub) in ("asyncio.gather", "asyncio.wait"):
                if sub is node:
                    continue
                for a in sub.args:
                    target = a.value if isinstance(a, ast.Starred) else a
                    if (
                        isinstance(target, ast.Name)
                        and target.id in candidates
                    ):
                        return
        yield ctx.finding(
            self, node,
            "asyncio.wait(FIRST_COMPLETED): the losing waiter tasks are "
            "never cancelled — cancel (or await) the pending set on every "
            "exit path",
        )
