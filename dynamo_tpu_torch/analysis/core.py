"""AST checker framework for the port's source planes.

The counterpart of the JAX package's ``analysis/core.py``: a rule
registry (``rules_async.py``, DT001-DT004, and ``rules_torch.py``,
DT101-DT105, the counterpart of the JAX package's ``rules_jax.py`` read
for eager PyTorch and the hand-written kernels), per-line suppression
(``# dt: noqa[DTxxx]``), and a committed baseline (the port's own
``analysis/baseline.json``) for grandfathered findings, so the tier-1
gate starts green and stays zero-findings.  The jit registry the JAX
pre-scan builds for its rules is left out: the port's rules read
function names, decorators and paths.

Performance contract: each file is parsed ONCE and all rules run off the
same tree — one cheap pre-scan walk (the import table, shared by every
rule) and one main visitor pass that dispatches nodes to the rules
interested in them.  The whole package lints well inside the 20s
per-test tier-1 budget.

Baseline entries match on (path, rule, line content) — not line number —
so unrelated edits above a grandfathered finding don't break the gate.
Matching is a multiset: N identical findings need N entries.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator, Optional, Sequence

__all__ = [
    "Finding",
    "Rule",
    "ModuleContext",
    "Baseline",
    "DEFAULT_BASELINE_PATH",
    "all_rules",
    "lint_file",
    "lint_paths",
    "iter_python_files",
    "parse_module",
]

DEFAULT_BASELINE_PATH = Path(__file__).parent / "baseline.json"

_NOQA_RE = re.compile(r"#\s*dt:\s*noqa(?:\[([A-Za-z0-9_,\s]+)\])?")


@dataclass(frozen=True, order=True)
class Finding:
    path: str  # posix path relative to the lint root
    line: int
    col: int
    rule: str
    message: str
    snippet: str = ""  # stripped source line — the baseline content key

    @property
    def baseline_key(self) -> tuple[str, str, str]:
        return (self.path, self.rule, self.snippet)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "message": self.message,
            "snippet": self.snippet,
        }


# ------------------------------------------------------------------ rules ----


class Rule:
    """One checker.  ``interests`` lists the AST node types the main pass
    dispatches to ``visit``; ``begin_module`` sees the shared pre-scan."""

    code: str = "DT000"
    name: str = ""
    summary: str = ""
    interests: tuple = ()

    def begin_module(self, ctx: "ModuleContext") -> None:
        pass

    def visit(self, node: ast.AST, ctx: "ModuleContext") -> Iterable[Finding]:
        return ()


_REGISTRY: dict[str, type[Rule]] = {}


def register(cls: type[Rule]) -> type[Rule]:
    _REGISTRY[cls.code] = cls
    return cls


def all_rules(select: Optional[Sequence[str]] = None) -> list[Rule]:
    # importing the rule module populates the registry
    from dynamo_tpu_torch.analysis import rules_async, rules_torch  # noqa: F401

    codes = sorted(_REGISTRY)
    if select:
        wanted = {c.strip().upper() for c in select}
        unknown = wanted - set(codes)
        if unknown:
            raise ValueError(f"unknown rule code(s): {sorted(unknown)}")
        codes = [c for c in codes if c in wanted]
    return [_REGISTRY[c]() for c in codes]


# -------------------------------------------------------------- module ctx ----


class ModuleContext:
    """Per-file state handed to every rule: the parsed tree, source
    lines, import table, and the walker's scope stacks."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.imports: dict[str, str] = {}
        # walker-maintained scope state
        self.func_stack: list[ast.AST] = []  # FunctionDef/AsyncFunctionDef
        self.loop_depth = 0  # loops in the INNERMOST function (or module)
        self._noqa: Optional[dict[int, Optional[set[str]]]] = None

    # ------------------------------------------------------------- scopes
    @property
    def in_async(self) -> bool:
        """True when the innermost enclosing function is ``async def``
        (a nested sync ``def`` inside an async one is NOT async)."""
        return bool(self.func_stack) and isinstance(
            self.func_stack[-1], ast.AsyncFunctionDef
        )

    @property
    def current_func(self) -> Optional[ast.AST]:
        return self.func_stack[-1] if self.func_stack else None

    # ------------------------------------------------------------- names
    def canonical(self, dotted: str) -> str:
        """Resolve the leading segment through the import table:
        ``sp.run`` -> ``subprocess.run`` under ``import subprocess as
        sp``; ``sleep`` -> ``time.sleep`` under ``from time import
        sleep``."""
        head, sep, rest = dotted.partition(".")
        base = self.imports.get(head, head)
        return base + (("." + rest) if rest else "")

    def call_name(self, node: ast.Call) -> str:
        """Canonical dotted name of a call's target ('' if dynamic)."""
        return self.canonical(dotted_name(node.func))

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    # -------------------------------------------------------------- noqa
    def is_suppressed(self, finding: Finding) -> bool:
        if self._noqa is None:
            self._noqa = {}
            for i, text in enumerate(self.lines, start=1):
                m = _NOQA_RE.search(text)
                if m:
                    codes = m.group(1)
                    self._noqa[i] = (
                        {c.strip().upper() for c in codes.split(",")}
                        if codes
                        else None  # blanket noqa
                    )
        codes = self._noqa.get(finding.line, "missing")
        if codes == "missing":
            return False
        return codes is None or finding.rule in codes

    def finding(self, rule: Rule, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            path=self.path,
            line=line,
            col=col,
            rule=rule.code,
            message=message,
            snippet=self.line_text(line),
        )


def dotted_name(node: ast.AST) -> str:
    """'a.b.c' for Name/Attribute chains, '' for anything dynamic."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# ---------------------------------------------------------------- pre-scan ----


def _prescan(ctx: ModuleContext) -> None:
    """One walk collecting the import table (shared by all rules and the
    project index) before the main pass."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                ctx.imports[alias.asname or alias.name.split(".")[0]] = (
                    alias.name
                )
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.level == 0:
                for alias in node.names:
                    ctx.imports[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}"
                    )


# ------------------------------------------------------------- main walker ----


class _Walker:
    """Single visitor pass: maintains scope stacks on the ctx, links
    parents (``node._dt_parent``), and dispatches each node to the rules
    interested in its type."""

    def __init__(self, ctx: ModuleContext, rules: Sequence[Rule]):
        self.ctx = ctx
        self.findings: list[Finding] = []
        self._dispatch: dict[type, list[Rule]] = {}
        for rule in rules:
            for t in rule.interests:
                self._dispatch.setdefault(t, []).append(rule)

    def walk(self) -> list[Finding]:
        self._visit(self.ctx.tree, None)
        return self.findings

    def _visit(self, node: ast.AST, parent: Optional[ast.AST]) -> None:
        node._dt_parent = parent  # type: ignore[attr-defined]
        ctx = self.ctx
        for rule in self._dispatch.get(type(node), ()):
            self.findings.extend(rule.visit(node, ctx))

        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ctx.func_stack.append(node)
            outer_loops, ctx.loop_depth = ctx.loop_depth, 0
            for child in ast.iter_child_nodes(node):
                self._visit(child, node)
            ctx.loop_depth = outer_loops
            ctx.func_stack.pop()
        elif isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            ctx.loop_depth += 1
            for child in ast.iter_child_nodes(node):
                self._visit(child, node)
            ctx.loop_depth -= 1
        else:
            for child in ast.iter_child_nodes(node):
                self._visit(child, node)


# ---------------------------------------------------------------- baseline ----


class Baseline:
    """Committed grandfathered findings.  Entries carry a one-line
    ``justification``; matching is a (path, rule, content) multiset."""

    def __init__(self, entries: Optional[list[dict]] = None):
        self.entries: list[dict] = entries or []

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not Path(path).is_file():
            return cls()
        data = json.loads(Path(path).read_text())
        return cls(list(data.get("entries", [])))

    def save(self, path: Path) -> None:
        entries = sorted(
            self.entries,
            key=lambda e: (e["path"], e["rule"], e.get("line", 0)),
        )
        Path(path).write_text(
            json.dumps({"version": 1, "entries": entries}, indent=2)
            + "\n"
        )

    def _counts(self) -> dict[tuple[str, str, str], int]:
        counts: dict[tuple[str, str, str], int] = {}
        for e in self.entries:
            key = (e["path"], e["rule"], e.get("content", ""))
            counts[key] = counts.get(key, 0) + 1
        return counts

    def filter(self, findings: Iterable[Finding]) -> list[Finding]:
        """Findings NOT covered by the baseline (stable-sorted)."""
        budget = self._counts()
        fresh: list[Finding] = []
        for f in sorted(findings):
            key = f.baseline_key
            if budget.get(key, 0) > 0:
                budget[key] -= 1
            else:
                fresh.append(f)
        return fresh

    @classmethod
    def from_findings(
        cls, findings: Iterable[Finding], previous: "Baseline"
    ) -> "Baseline":
        """Rebuild from current findings, carrying justifications over
        from the previous baseline where the key still matches."""
        just: dict[tuple[str, str, str], list[str]] = {}
        for e in previous.entries:
            key = (e["path"], e["rule"], e.get("content", ""))
            just.setdefault(key, []).append(e.get("justification", ""))
        entries = []
        for f in sorted(findings):
            carried = just.get(f.baseline_key)
            entries.append({
                "path": f.path,
                "rule": f.rule,
                "line": f.line,
                "content": f.snippet,
                "justification": (
                    carried.pop(0) if carried else "TODO: justify"
                ),
            })
        return cls(entries)


# ----------------------------------------------------------------- drivers ----

# Parse-once cache shared by the per-file pass (lint_file) and the
# interprocedural pass (project.ProjectIndex): running both over the same
# tree — as `lint --project` and the tier-1 gate do — pays the
# ast.parse cost once per file.  Keyed on (mtime_ns, size) so edited
# files (fixtures, tmp paths in tests) re-parse.
_PARSE_CACHE: dict[str, tuple[tuple[int, int], str, ast.Module]] = {}


def parse_module(path: Path) -> tuple[str, ast.Module]:
    """Return (source, tree) for ``path``, cached on content identity.
    Raises SyntaxError for unparsable files (callers decide whether that
    is a DT000 finding or a skip)."""
    p = str(Path(path).resolve())
    try:
        st = os.stat(p)
        key = (st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    hit = _PARSE_CACHE.get(p)
    if hit is not None and key is not None and hit[0] == key:
        return hit[1], hit[2]
    source = Path(p).read_text(encoding="utf-8", errors="replace")
    tree = ast.parse(source)
    if key is not None:
        _PARSE_CACHE[p] = (key, source, tree)
    return source, tree


def iter_python_files(paths: Sequence[Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def lint_file(
    path: Path,
    rules: Sequence[Rule],
    root: Optional[Path] = None,
) -> list[Finding]:
    """Parse ``path`` once, run every rule in one pass, apply noqa."""
    path = Path(path)
    rel = path
    if root is not None:
        try:
            rel = path.resolve().relative_to(Path(root).resolve())
        except ValueError:
            rel = path
    try:
        source, tree = parse_module(path)
    except SyntaxError as e:
        return [Finding(
            path=rel.as_posix(), line=e.lineno or 1, col=e.offset or 0,
            rule="DT000", message=f"syntax error: {e.msg}",
            snippet=(e.text or "").strip(),
        )]
    ctx = ModuleContext(rel.as_posix(), source, tree)
    _prescan(ctx)
    for rule in rules:
        rule.begin_module(ctx)
    findings = _Walker(ctx, rules).walk()
    return sorted(f for f in findings if not ctx.is_suppressed(f))


def lint_paths(
    paths: Sequence[Path],
    rules: Optional[Sequence[Rule]] = None,
    root: Optional[Path] = None,
) -> list[Finding]:
    rules = list(rules) if rules is not None else all_rules()
    out: list[Finding] = []
    for f in iter_python_files([Path(p) for p in paths]):
        out.extend(lint_file(f, rules, root=root))
    return sorted(out)
