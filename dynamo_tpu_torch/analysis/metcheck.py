"""Metrics contract plane (dtmet) over the port: static audit of the
port's /metrics surface.

The counterpart of the JAX package's ``analysis/metcheck.py``: the same
census, rules MT001-MT005 and helpers (the const-table helpers come from
the port's ``wirecheck.py``), over the port's package, its tests
(``tests/test_torch_*.py``) and ``chip_smoke.py``, against the port's
own committed ``analysis/metrics_manifest.json``, the port's
``obs/metric_names.SCHEMA`` and the port's own generated reference
table in ``docs/torch_observability.md``.  The manifest contract (one
accepted list of justified findings keyed on (metric, rule, key),
``--update-baseline`` carrying justifications over) is a copy of the one
the JAX plane takes from its compile plane, which is not a port target.

The port spells metric names as the JAX package does (``METRIC_PREFIX``
is ``"dynamo_tpu_"``), and the port's package name starts with that
prefix too.  So here a string that names the port's package or one of
its modules (the package name as a whole name run: ``<package>``,
``<package>.x.y``, ``<package>/x``, ``-m <package> run``) is a module
path, never a scrape.

* **producers** — counter/gauge/histogram record sites (the process-
  global counter singletons in engine/counters.py, fault/counters.py,
  obs/costs.py, obs/timeline.py, obs/perfmodel.py) reached as the
  value expressions backing rendered samples;
* **renderers** — every ``# TYPE`` declaration and sample line built
  in a render context (``lines.append(...)`` / ``lines.extend(...)`` /
  ``yield``), with f-string name composition resolved through the
  project-wide const table (dtwire idiom) so registry constants like
  ``HttpMetric.REQUESTS_TOTAL`` bottom out at their literals;
* **consumers** — scrape-string literals and registry references in
  the port's tests and ``chip_smoke.py``, plus constant-key reads of the
  ``EngineCore.metrics()`` dict.

Rules:

* **MT001** recorded-but-never-rendered — a counter attr assigned in a
  producer's ``reset()`` (or a stats-dict key) that nothing in the
  serving tree ever reads: dead telemetry, or a renderer that forgot a
  family member.
* **MT002** scraped-but-never-produced — the WR002 twin: a scrape
  literal / registry reference / engine-dict key with no renderer
  behind it; the finding detail names the exact stale scrape site.
* **MT003** unbounded-label-cardinality — a label value data-flows
  from per-request identity (request/session/tenant/hash/trace ids)
  instead of a closed enum.
* **MT004** type-misuse — counter not ``_total``; histogram units not
  ``_seconds``/``_bytes``; a counter that is decremented or plainly
  re-assigned outside ``reset``/``__init__``; conflicting TYPE lines.
* **MT005** census-drift — the extracted census disagrees with the
  committed manifest, the metric_names registry SCHEMA, or the
  generated table in ``docs/torch_observability.md``.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from dynamo_tpu_torch.analysis.core import dotted_name, iter_python_files
from dynamo_tpu_torch.analysis.project import ProjectIndex
from dynamo_tpu_torch.analysis.wirecheck import _const_table, _lit_values, _param_names

__all__ = [
    "MET_RULES",
    "METRIC_PREFIX",
    "DEFAULT_METRICS_MANIFEST_PATH",
    "DOCS_PATH",
    "MetricFinding",
    "MetricsManifest",
    "collect_metric_facts",
    "check_metric_facts",
    "census_snapshot",
    "render_docs_table",
    "run_metrics",
]

MET_RULES = {
    "MT001": ("recorded-never-rendered",
              "a producer records state no renderer or reader consumes"),
    "MT002": ("scraped-never-produced",
              "a scrape site names a metric no renderer emits"),
    "MT003": ("unbounded-label-cardinality",
              "a label value flows from per-request identity data"),
    "MT004": ("type-misuse",
              "metric name/TYPE disagrees with how the backing is used"),
    "MT005": ("census-drift",
              "extracted census disagrees with manifest/registry/docs"),
}

DEFAULT_METRICS_MANIFEST_PATH = Path(__file__).parent / "metrics_manifest.json"

METRIC_PREFIX = "dynamo_tpu_"

# the port's package: a name run equal to it is a module path, not a scrape
PORT_PACKAGE = __name__.split(".")[0]

# the port's own generated metric reference table (the JAX package's
# docs/observability.md belongs to the JAX package)
DOCS_PATH = Path("docs") / "torch_observability.md"

# histogram child-series suffixes fold back onto the base name
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")

# identifier fragments that mark per-request identity flowing into a label
_CARDINALITY_TOKENS = (
    "request_id", "req_id", "session", "tenant", "user", "uuid",
    "trace", "span", "hash", "digest", "token_id",
)

_TYPE_RE = re.compile(r"^# TYPE ([A-Za-z_][A-Za-z0-9_]*) ([a-z]+)\s*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"(?:\{(?P<labels>[^}]*)\})?(?P<rest> .*)?$",
    re.S,
)
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="([^"]*)"')
_HOLE_RE = re.compile(r"^\x00(\d+)\x01$")
_NAME_RUN_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


# ------------------------------------------------- findings + manifest ----


@dataclass(frozen=True, order=True)
class MetricFinding:
    """One metrics-plane finding.  ``(entrypoint, rule, key)`` is the
    stable acceptance key; ``entrypoint`` carries the metric name (or the
    surface a finding is about), as the JAX plane's findings do."""

    entrypoint: str
    rule: str
    key: str
    message: str

    @property
    def accept_key(self) -> tuple[str, str, str]:
        return (self.entrypoint, self.rule, self.key)

    def render(self) -> str:
        return f"{self.entrypoint}: {self.rule}[{self.key}] {self.message}"

    def to_json(self) -> dict:
        return {
            "entrypoint": self.entrypoint,
            "rule": self.rule,
            "key": self.key,
            "message": self.message,
        }


class MetricsManifest:
    """The committed census (``entrypoints``: metric name -> type and
    labels) plus accepted (justified) findings, matched as a (metric,
    rule, key) multiset; ``--update-baseline`` re-snapshots the census
    and carries justifications over where the key still matches."""

    def __init__(self, entrypoints: Optional[dict] = None,
                 accepted: Optional[list[dict]] = None,
                 header: Optional[dict] = None):
        self.entrypoints: dict = entrypoints or {}
        self.accepted: list[dict] = accepted or []
        self.header: dict = header or {}

    @classmethod
    def load(cls, path: Path) -> "MetricsManifest":
        if not Path(path).is_file():
            return cls()
        data = json.loads(Path(path).read_text())
        return cls(dict(data.get("entrypoints", {})),
                   list(data.get("accepted", [])),
                   dict(data.get("header", {})))

    def save(self, path: Path) -> None:
        doc = {
            "version": 1,
            "header": self.header or _met_header(),
            "entrypoints": self.entrypoints,
            "accepted": sorted(
                self.accepted,
                key=lambda e: (e["entrypoint"], e["rule"], e["key"]),
            ),
        }
        Path(path).write_text(
            json.dumps(doc, indent=2, sort_keys=True) + "\n"
        )

    def filter(self, findings: list[MetricFinding]) -> list[MetricFinding]:
        """Findings NOT covered by an accepted entry (stable-sorted)."""
        budget: dict[tuple[str, str, str], int] = {}
        for e in self.accepted:
            key = (e["entrypoint"], e["rule"], e["key"])
            budget[key] = budget.get(key, 0) + 1
        fresh: list[MetricFinding] = []
        for f in sorted(findings):
            if budget.get(f.accept_key, 0) > 0:
                budget[f.accept_key] -= 1
            else:
                fresh.append(f)
        return fresh

    @classmethod
    def from_facts(cls, facts: dict, findings: list[MetricFinding],
                   previous: "MetricsManifest") -> "MetricsManifest":
        """Re-snapshot: the census becomes the committed entrypoints;
        findings become accepted entries, carrying the previous
        justification where (entrypoint, rule, key) still matches."""
        just: dict[tuple[str, str, str], list[str]] = {}
        for e in previous.accepted:
            key = (e["entrypoint"], e["rule"], e["key"])
            just.setdefault(key, []).append(e.get("justification", ""))
        accepted = []
        for f in sorted(findings):
            carried = just.get(f.accept_key)
            accepted.append({
                "entrypoint": f.entrypoint,
                "rule": f.rule,
                "key": f.key,
                "message": f.message,
                "justification": (
                    carried.pop(0) if carried else "TODO: justify"
                ),
            })
        return cls(facts, accepted, previous.header or None)


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def _scan_files(root: Path) -> list[Path]:
    """Default scan scope: the port's package, its tests
    (``tests/test_torch_*.py``) and ``chip_smoke.py`` — minus the
    analysis plane itself and this plane's own test, which spell every
    violation on purpose.  The JAX package, its benchmarks and bench.py
    are the JAX plane's."""
    files = [p for p in iter_python_files([root / PORT_PACKAGE])
             if f"{PORT_PACKAGE}/analysis/" not in p.as_posix()]
    tests = root / "tests"
    if tests.is_dir():
        files += [p for p in sorted(tests.glob("test_torch_*.py"))
                  if p.name != "test_torch_metcheck.py"]
    smoke = root / "chip_smoke.py"
    if smoke.is_file():
        files.append(smoke)
    return files


def _is_module_path(text: str, start: int, end: int) -> bool:
    """The name run ``text[start:end]`` is the port's package name itself,
    a module or file path (``<package>``, ``<package>.x.y``,
    ``<package>/x``, ``-m <package> run``), not a metric name; a
    template hole right after it would make it a family prefix."""
    return (text[start:end] == PORT_PACKAGE
            and (end == len(text) or text[end] != "\x00"))


def _flatten(parts: list) -> tuple[str, list]:
    """Parts -> (text-with-hole-sentinels, holes).  A hole renders as
    \\x00<idx>\\x01 so regexes can treat it as an opaque token."""
    text: list[str] = []
    holes: list = []
    for kind, val in parts:
        if kind == "lit":
            text.append(val)
        else:
            text.append(f"\x00{len(holes)}\x01")
            holes.append(val)
    return "".join(text), holes


def _merge_lits(parts: list) -> list:
    out: list = []
    for kind, val in parts:
        if kind == "lit" and out and out[-1][0] == "lit":
            out[-1] = ("lit", out[-1][1] + val)
        else:
            out.append((kind, val))
    return out


# ------------------------------------------------------------- extraction ----


class _Sink:
    """Cross-module fact accumulator for one collect run."""

    def __init__(self) -> None:
        # (name, type, site, modname) from render-context TYPE lines
        self.type_decls: list[tuple[str, str, str, str]] = []
        # sample dicts: name/labels/backing/site/modname
        self.samples: list[dict] = []
        # (name, wildcard, site) scrape-string occurrences
        self.raw_consumers: list[tuple[str, bool, str]] = []
        # (modname, literal, site) registry references outside renderers
        self.dotted_refs: list[tuple[str, str, str]] = []
        # constant dict keys read anywhere (subscript Load / .get)
        self.consumed_keys: set[str] = set()
        # (class_key, method) registered dict surfaces
        self.dict_surfaces: set[tuple[str, str]] = set()
        # engine-dict constant-key reads: key -> [sites]
        self.engine_reads: dict[str, list[str]] = {}


class _ModuleWalk:
    """Statement-level walk of one module: binds template/alias env,
    recognizes render contexts, and records facts into the sink."""

    def __init__(self, sink: _Sink, ctx, modname: str,
                 consts: dict[str, str],
                 singletons: dict[str, str],
                 classmap: dict[str, tuple[str, ast.ClassDef]]):
        self.sink = sink
        self.ctx = ctx
        self.modname = modname
        self.consts = consts
        self.singletons = singletons
        self.classmap = classmap
        self.path = ctx.path.as_posix() if hasattr(ctx.path, "as_posix") \
            else str(ctx.path)
        self._used: set[int] = set()

    # ------------------------------------------------------------- entry ----
    def run(self) -> None:
        self._stmts(self.ctx.tree.body, {}, {}, 0)
        for node in self.ctx.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._stmts(node.body, {}, {}, 0)
            elif isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._stmts(m.body, {}, {}, 0)

    def _site(self, node) -> str:
        return f"{self.path}:{getattr(node, 'lineno', 0)}"

    # -------------------------------------------------------- resolution ----
    def _resolve(self, expr, env) -> list:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return [("lit", expr.value)]
        if isinstance(expr, ast.JoinedStr):
            parts: list = []
            for v in expr.values:
                if isinstance(v, ast.Constant):
                    parts.append(("lit", str(v.value)))
                elif isinstance(v, ast.FormattedValue):
                    parts.extend(self._resolve_hole(v.value, env))
            return _merge_lits(parts)
        return self._resolve_hole(expr, env)

    def _resolve_hole(self, expr, env) -> list:
        if isinstance(expr, ast.Name):
            b = env.get(expr.id)
            if b and b[0] == "tpl":
                return list(b[1])
        vals = _lit_values(expr, self.ctx, self.modname, self.consts)
        if len(vals) == 1 and vals[0] != "?":
            return [("lit", vals[0])]
        self._consume_in(expr, env)
        return [("hole", expr)]

    def _consume_in(self, expr, env) -> None:
        """Constant dict-key reads inside an unresolved template hole
        still count as consumption (``{round(tl['ewma_wall_ms'], 6)}``
        consumes the snapshot key)."""
        for n in ast.walk(expr):
            if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Load):
                key = self._const_key(n.slice, env)
                if key is not None:
                    self.sink.consumed_keys.add(key)
            elif (isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)
                  and n.func.attr == "get" and n.args):
                key = self._const_key(n.args[0], env)
                if key is not None:
                    self.sink.consumed_keys.add(key)

    def _const_key(self, expr, env) -> Optional[str]:
        """Literal value of a subscript/.get key expression, through
        env-bound loop variables."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            b = env.get(expr.id)
            if b and b[0] == "tpl" and len(b[1]) == 1 and b[1][0][0] == "lit":
                return b[1][0][1]
        return None

    def _lit_of(self, expr, env) -> Optional[str]:
        parts = self._resolve(expr, env)
        if len(parts) == 1 and parts[0][0] == "lit":
            return parts[0][1]
        return None

    def _backing(self, expr, env) -> Optional[tuple[str, str]]:
        """(class_key, attr) behind a sample value expression, resolved
        through numeric wrappers, env object aliases, and the
        module-level singleton table."""
        e = expr
        while (isinstance(e, ast.Call) and isinstance(e.func, ast.Name)
               and e.func.id in ("round", "int", "float", "abs", "len")
               and e.args):
            e = e.args[0]
        d = dotted_name(e)
        if not d:
            return None
        head, _, rest = d.partition(".")
        b = env.get(head)
        cands = []
        if b and b[0] == "obj":
            cands.append(b[1] + ("." + rest if rest else ""))
        else:
            cands.append(self.ctx.canonical(d))
            cands.append(f"{self.modname}.{d}")
        for cand in cands:
            for s_dotted, cls_key in self.singletons.items():
                if cand.startswith(s_dotted + "."):
                    attr = cand[len(s_dotted) + 1:]
                    if attr and "." not in attr:
                        return (cls_key, attr)
        return None

    def _singleton_of(self, expr, env) -> Optional[str]:
        """Singleton dotted key an expression resolves to, or None."""
        d = dotted_name(expr)
        if not d:
            return None
        head, _, rest = d.partition(".")
        b = env.get(head)
        cands = []
        if b and b[0] == "obj":
            cands.append(b[1] + ("." + rest if rest else ""))
        else:
            cands.append(self.ctx.canonical(d))
            cands.append(f"{self.modname}.{d}")
        for cand in cands:
            if cand in self.singletons:
                return cand
        return None

    # ------------------------------------------------------------- walk ----
    def _stmts(self, body, env, lf, depth) -> None:
        for stmt in body:
            self._stmt(stmt, env, lf, depth)

    def _stmt(self, stmt, env, lf, depth) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lf[stmt.name] = stmt
            return
        if isinstance(stmt, ast.ClassDef):
            return
        if isinstance(stmt, ast.If):
            self._scan(stmt.test, env, lf, depth)
            self._stmts(stmt.body, env, lf, depth)
            self._stmts(stmt.orelse, env, lf, depth)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            if self._literal_for(stmt, env, lf, depth):
                return
            self._scan(stmt.iter, env, lf, depth)
            self._stmts(stmt.body, env, lf, depth)
            self._stmts(stmt.orelse, env, lf, depth)
            return
        if isinstance(stmt, ast.While):
            self._scan(stmt.test, env, lf, depth)
            self._stmts(stmt.body, env, lf, depth)
            self._stmts(stmt.orelse, env, lf, depth)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan(item.context_expr, env, lf, depth)
            self._stmts(stmt.body, env, lf, depth)
            return
        if isinstance(stmt, ast.Try):
            self._stmts(stmt.body, env, lf, depth)
            for h in stmt.handlers:
                self._stmts(h.body, env, lf, depth)
            self._stmts(stmt.orelse, env, lf, depth)
            self._stmts(stmt.finalbody, env, lf, depth)
            return
        # simple statements -------------------------------------------------
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            return  # docstring / bare literal — not a scrape site
        self._render_contexts(stmt, env, lf, depth)
        if isinstance(stmt, ast.Assign):
            self._assign(stmt, env)
        self._scan(stmt, env, lf, depth)

    def _literal_for(self, stmt, env, lf, depth) -> bool:
        """``for a, b in ((lit, lit), ...)`` and ``for a in ("x", "y")``
        unroll with the loop variables bound to their literal values, so
        templates built from them resolve fully.  The port's renderer also
        walks rows that mix literals with value expressions (``for name,
        typ, val in ((EM.X, "counter", counters.x), ...)``): a row's
        non-literal element binds as a template hole holding that
        expression, so the sample's backing resolves as if the expression
        were written in the template.  A row with no literal at all stops
        the unroll."""
        tgt, it = stmt.target, stmt.iter
        if not isinstance(it, ast.Tuple):
            return False
        rows: list[list] = []
        holes: list = []
        if isinstance(tgt, ast.Tuple) and all(
                isinstance(n, ast.Name) for n in tgt.elts):
            names = [n.id for n in tgt.elts]
            for elt in it.elts:
                if not (isinstance(elt, ast.Tuple)
                        and len(elt.elts) == len(names)):
                    return False
                row = []
                for e in elt.elts:
                    v = self._lit_of(e, env)
                    row.append(("lit", v) if v is not None else ("hole", e))
                    if v is None:
                        holes.append(e)
                if all(kind == "hole" for kind, _ in row):
                    return False
                rows.append(row)
        elif isinstance(tgt, ast.Name):
            names = [tgt.id]
            for elt in it.elts:
                v = self._lit_of(elt, env)
                if v is None:
                    return False
                rows.append([("lit", v)])
        else:
            return False
        for e in holes:
            self._scan(e, env, lf, depth)
        self._mark_used(it)
        for row in rows:
            env2 = dict(env)
            for name, part in zip(names, row):
                env2[name] = ("tpl", [part])
            self._stmts(stmt.body, env2, lf, depth)
        return True

    def _assign(self, stmt: ast.Assign, env) -> None:
        if len(stmt.targets) != 1 or not isinstance(stmt.targets[0], ast.Name):
            return
        name = stmt.targets[0].id
        val = stmt.value
        # template binding: labels = f'model="{m}"'
        if isinstance(val, (ast.Constant, ast.JoinedStr)):
            parts = self._resolve(val, env)
            if any(k == "lit" for k, _ in parts):
                env[name] = ("tpl", parts)
            return
        # engine metrics dict: stats = engine.metrics()
        if isinstance(val, ast.Call) and not val.args and not val.keywords:
            fd = dotted_name(val.func)
            if fd and fd.endswith(".metrics"):
                env[name] = ("eng",)
                return
            # dict surface: tl = step_timeline.snapshot()
            if fd and isinstance(val.func, ast.Attribute):
                s = self._singleton_of(val.func.value, env)
                if s is not None:
                    cls_key = self.singletons[s]
                    method = val.func.attr
                    if method in _surface_methods(self.classmap, cls_key):
                        self.sink.dict_surfaces.add((cls_key, method))
                        env[name] = ("dict", cls_key, method)
                        return
        # object alias: sc = kv_shard_counters
        if isinstance(val, (ast.Name, ast.Attribute)):
            s = self._singleton_of(val, env)
            if s is not None:
                env[name] = ("obj", s)

    # ---------------------------------------------------- render contexts ----
    def _render_contexts(self, stmt, env, lf, depth) -> None:
        expr = stmt.value if isinstance(stmt, ast.Expr) else None
        if isinstance(expr, ast.Yield) and expr.value is not None:
            self._emit_render(expr.value, env)
            return
        if (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)
                and expr.func.attr in ("append", "extend")):
            for a in expr.args:
                if isinstance(a, (ast.Constant, ast.JoinedStr)):
                    self._emit_render(a, env)
                elif isinstance(a, ast.Call):
                    self._maybe_hist_render(a, env)

    def _maybe_hist_render(self, call: ast.Call, env) -> bool:
        """``lines.extend(h.render(NAME, labels))`` — the Histogram
        helper expands to _bucket/_sum/_count series for NAME."""
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr == "render" and len(call.args) == 2):
            return False
        name = self._lit_of(call.args[0], env)
        if not name or not name.startswith(METRIC_PREFIX):
            return False
        parts = self._resolve(call.args[1], env)
        text, holes = _flatten(parts)
        labels = []
        for ln, lv in _LABEL_RE.findall(text):
            hm = _HOLE_RE.match(lv)
            src = ast.unparse(holes[int(hm.group(1))]) if hm else None
            labels.append((ln, src))
        self.sink.samples.append({
            "name": name, "labels": labels, "backing": None,
            "site": self._site(call), "modname": self.modname,
        })
        self._mark_used(call)
        return True

    def _emit_render(self, expr, env) -> None:
        if not isinstance(expr, (ast.Constant, ast.JoinedStr)):
            return
        parts = self._resolve(expr, env)
        text, holes = _flatten(parts)
        self._mark_used(expr)
        if text.startswith("# HELP"):
            return
        m = _TYPE_RE.match(text)
        if m:
            if m.group(1).startswith(METRIC_PREFIX):
                self.sink.type_decls.append(
                    (m.group(1), m.group(2), self._site(expr), self.modname))
            return
        m = _SAMPLE_RE.match(text)
        if not m or not m.group("name").startswith(METRIC_PREFIX):
            return
        rest = m.group("rest")
        if not rest or not rest.strip():
            return
        labels = []
        for ln, lv in _LABEL_RE.findall(m.group("labels") or ""):
            hm = _HOLE_RE.match(lv)
            src = ast.unparse(holes[int(hm.group(1))]) if hm else None
            labels.append((ln, src))
        vh = _HOLE_RE.match(rest.strip())
        backing = None
        if vh is not None:
            backing = self._backing(holes[int(vh.group(1))], env)
        self.sink.samples.append({
            "name": m.group("name"), "labels": labels, "backing": backing,
            "site": self._site(expr), "modname": self.modname,
        })

    def _mark_used(self, node) -> None:
        for n in ast.walk(node):
            self._used.add(id(n))

    # ------------------------------------------------------- generic scan ----
    def _scan(self, node, env, lf, depth) -> None:
        if node is None or id(node) in self._used:
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(node, (ast.Constant, ast.JoinedStr)):
            self._consumer_string(node, env)
            if isinstance(node, ast.JoinedStr):
                for v in node.values:
                    if isinstance(v, ast.FormattedValue):
                        self._scan(v.value, env, lf, depth)
            return
        if isinstance(node, ast.Attribute):
            self._dotted_ref(node, env)
            self._scan(node.value, env, lf, depth)
            return
        if isinstance(node, ast.Subscript):
            key = self._const_key(node.slice, env)
            if key is not None and isinstance(node.ctx, ast.Load):
                self.sink.consumed_keys.add(key)
                self._engine_read(node.value, key, env, node)
            for child in ast.iter_child_nodes(node):
                self._scan(child, env, lf, depth)
            return
        if isinstance(node, ast.Call):
            self._call(node, env, lf, depth)
            for child in ast.iter_child_nodes(node):
                self._scan(child, env, lf, depth)
            return
        for child in ast.iter_child_nodes(node):
            self._scan(child, env, lf, depth)

    def _call(self, node: ast.Call, env, lf, depth) -> None:
        # .get("key") consumption (incl. engine dict reads)
        if (isinstance(node.func, ast.Attribute) and node.func.attr == "get"
                and node.args):
            key = self._const_key(node.args[0], env)
            if key is not None:
                self.sink.consumed_keys.add(key)
                self._engine_read(node.func.value, key, env, node)
        # local helper call: recurse with literal args bound (the
        # components/metrics.py ``gauge(name, help)`` idiom)
        if (isinstance(node.func, ast.Name) and node.func.id in lf
                and depth < 2):
            fn = lf[node.func.id]
            env2: dict = {}
            for pname, arg in zip(_param_names(fn), node.args):
                parts = self._resolve(arg, env)
                if all(k == "lit" for k, _ in parts):
                    env2[pname] = ("tpl", parts)
            self._stmts(fn.body, env2, dict(lf), depth + 1)

    def _engine_read(self, base, key: str, env, node) -> None:
        """Record constant-key reads rooted in an ``.metrics()`` call or
        a variable bound to one."""
        eng = False
        if isinstance(base, ast.Name):
            b = env.get(base.id)
            eng = bool(b and b[0] == "eng")
        elif isinstance(base, ast.Call) and not base.args:
            fd = dotted_name(base.func)
            eng = bool(fd and fd.endswith(".metrics"))
        if eng:
            self.sink.engine_reads.setdefault(key, []).append(self._site(node))

    def _consumer_string(self, node, env) -> None:
        parts = self._resolve(node, env)
        text, _holes = _flatten(parts)
        if text.startswith("# TYPE "):
            m = _TYPE_RE.match(text)
            if m and m.group(1).startswith(METRIC_PREFIX):
                self.sink.raw_consumers.append(
                    (m.group(1), False, self._site(node)))
            return
        for m in _NAME_RUN_RE.finditer(text):
            name = m.group(0)
            if not name.startswith(METRIC_PREFIX):
                continue
            if _is_module_path(text, m.start(), m.end()):
                continue
            # a hole right after the run, or a trailing underscore,
            # marks a family-prefix match rather than one full name
            wildcard = ((m.end() < len(text) and text[m.end()] == "\x00")
                        or name.endswith("_"))
            self.sink.raw_consumers.append((name, wildcard, self._site(node)))

    def _dotted_ref(self, node: ast.Attribute, env) -> None:
        d = dotted_name(node)
        if not d:
            return
        for cand in (self.ctx.canonical(d), f"{self.modname}.{d}"):
            lit = self.consts.get(cand)
            if lit and lit.startswith(METRIC_PREFIX):
                self.sink.dotted_refs.append(
                    (self.modname, lit, self._site(node)))
                return


# ---------------------------------------------------------- class analysis ----


def _surface_methods(classmap, cls_key: str) -> set[str]:
    """Methods of ``cls_key`` that return a dict literal (stats/snapshot
    surfaces)."""
    entry = classmap.get(cls_key)
    if entry is None:
        return set()
    _, node = entry
    out = set()
    for m in node.body:
        if not isinstance(m, ast.FunctionDef):
            continue
        for n in ast.walk(m):
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict):
                out.add(m.name)
                break
    return out


def _surface_keys(classmap, cls_key: str, method: str) -> dict[str, str]:
    """Constant dict keys a registered surface exposes: dict literals in
    the method itself, plus dict literals the class stores into ``self``
    containers (the TransferCostTable.record idiom).  -> key: site"""
    entry = classmap.get(cls_key)
    if entry is None:
        return {}
    modpath, node = entry
    keys: dict[str, str] = {}

    def add_dicts(scope) -> None:
        for n in ast.walk(scope):
            if isinstance(n, ast.Dict):
                for k in n.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        keys.setdefault(
                            k.value, f"{modpath}:{getattr(k, 'lineno', 0)}")

    for m in node.body:
        if isinstance(m, ast.FunctionDef) and m.name == method:
            add_dicts(m)
    for m in node.body:
        if not isinstance(m, ast.FunctionDef):
            continue
        for n in ast.walk(m):
            if (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0],
                                   (ast.Subscript, ast.Attribute))
                    and isinstance(n.value, ast.Dict)):
                t = n.targets[0]
                base = t.value if isinstance(t, ast.Subscript) else t
                d = dotted_name(base)
                if d and d.split(".")[0] == "self":
                    add_dicts(n.value)
    return keys


def _reset_attrs(node: ast.ClassDef) -> dict[str, int]:
    """Public ``self.X = ...`` assignments in reset() -> attr: lineno."""
    out: dict[str, int] = {}
    for m in node.body:
        if not (isinstance(m, ast.FunctionDef) and m.name == "reset"):
            continue
        for n in ast.walk(m):
            targets = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, ast.AnnAssign):
                targets = [n.target]
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and not t.attr.startswith("_")):
                    out.setdefault(t.attr, n.lineno)
    return out


def _mutation_profile(node: ast.ClassDef) -> tuple[set[str], set[str]]:
    """(decremented attrs, plainly-assigned-outside-init/reset attrs)."""
    dec: set[str] = set()
    assigned: set[str] = set()
    for m in node.body:
        if not isinstance(m, ast.FunctionDef):
            continue
        for n in ast.walk(m):
            if (isinstance(n, ast.AugAssign) and isinstance(n.op, ast.Sub)
                    and isinstance(n.target, ast.Attribute)):
                dec.add(n.target.attr)
            if (isinstance(n, ast.Assign)
                    and m.name not in ("reset", "__init__")):
                for t in n.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        assigned.add(t.attr)
    return dec, assigned


def _producer_scope(path: str) -> bool:
    """Modules whose attribute reads count as in-tree consumption for
    MT001 (the tests and chip_smoke.py must not mask dead telemetry)."""
    p = path
    return not (p.startswith("tests/") or p == "chip_smoke.py"
                or "/tests/" in p)


# ------------------------------------------------------------- engine dict ----


def _engine_facts(index: ProjectIndex, classmap,
                  sink: _Sink) -> dict:
    """EngineCore.metrics() key surface + its constant-key consumers."""
    entry = None
    for key in classmap:
        if key.endswith(".EngineCore"):
            entry = classmap[key]
            break
    keys: set[str] = set()
    if entry is not None:
        modpath, node = entry
        attrtype: dict[str, str] = {}
        for n in ast.walk(node):
            if (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Attribute)
                    and isinstance(n.targets[0].value, ast.Name)
                    and n.targets[0].value.id == "self"
                    and isinstance(n.value, ast.Call)):
                cd = dotted_name(n.value.func)
                if cd:
                    attrtype[n.targets[0].attr] = cd
        metrics_fn = None
        for m in node.body:
            if isinstance(m, ast.FunctionDef) and m.name == "metrics":
                metrics_fn = m
                break
        if metrics_fn is not None:
            for n in ast.walk(metrics_fn):
                if isinstance(n, ast.Dict):
                    for k in n.keys:
                        if isinstance(k, ast.Constant) and isinstance(
                                k.value, str):
                            keys.add(k.value)
                if (isinstance(n, ast.Assign) and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Subscript)
                        and isinstance(n.targets[0].slice, ast.Constant)
                        and isinstance(n.targets[0].slice.value, str)):
                    keys.add(n.targets[0].slice.value)
                # out.update(self.X.stats()), and the port's
                # {..., **(self.X.stats() if self.X is not None else {})}:
                # fold in that class's keys
                folded = []
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "update" and n.args):
                    folded.append(n.args[0])
                if isinstance(n, ast.Dict):
                    folded += [v.body if isinstance(v, ast.IfExp) else v
                               for k, v in zip(n.keys, n.values) if k is None]
                for call in folded:
                    if not (isinstance(call, ast.Call)
                            and isinstance(call.func, ast.Attribute)):
                        continue
                    inner = call.func
                    d = dotted_name(inner.value)
                    if d and d.startswith("self."):
                        cd = attrtype.get(d[5:])
                        cls_entry = _resolve_class(index, classmap, cd)
                        if cls_entry:
                            keys.update(_surface_keys(
                                classmap, cls_entry, inner.attr))
    return {
        "keys": sorted(keys),
        "consumers": {k: sorted(set(v))
                      for k, v in sorted(sink.engine_reads.items())},
    }


def _resolve_class(index: ProjectIndex, classmap,
                   dotted: Optional[str]) -> Optional[str]:
    """Constructor dotted name -> classmap key (searched by class
    basename when the canonical path isn't a direct hit)."""
    if not dotted:
        return None
    if dotted in classmap:
        return dotted
    base = dotted.split(".")[-1]
    hits = [k for k in classmap if k.endswith("." + base)]
    return hits[0] if len(hits) == 1 else None


# ---------------------------------------------------------------- assembly ----


def collect_metric_facts(paths=None, root=None) -> tuple[dict, list]:
    """Extract the metrics census + intrinsic findings (MT001/3/4).

    Returns ``(facts, intrinsic)``: facts carries the renderer census,
    the consumer sites, and the engine-dict surface; intrinsic carries
    the findings that are properties of the tree itself (drift rules
    MT002/MT005 need the manifest and live in check_metric_facts)."""
    root = Path(root) if root is not None else _repo_root()
    files = [Path(p) for p in paths] if paths is not None \
        else _scan_files(root)
    index = ProjectIndex.build(files, root=root)
    consts = _const_table(index)

    classmap: dict[str, tuple[str, ast.ClassDef]] = {}
    singletons: dict[str, str] = {}
    for modname, ctx in index.modules.items():
        p = ctx.path.as_posix() if hasattr(ctx.path, "as_posix") \
            else str(ctx.path)
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                classmap[f"{modname}.{node.name}"] = (p, node)
    for modname, ctx in index.modules.items():
        for node in ctx.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                cd = dotted_name(node.value.func)
                if not cd:
                    continue
                for cand in (ctx.canonical(cd), f"{modname}.{cd}"):
                    if cand in classmap:
                        singletons[
                            f"{modname}.{node.targets[0].id}"] = cand
                        break

    sink = _Sink()
    for modname, ctx in index.modules.items():
        if modname.endswith("metric_names"):
            continue  # the registry defines names; it neither renders
        _ModuleWalk(sink, ctx, modname, consts, singletons, classmap).run()

    # census: renderer TYPE decls + samples folded onto base names -------
    census: dict[str, dict] = {}
    type_conflicts: dict[str, set[str]] = {}
    for name, typ, site, _mod in sink.type_decls:
        if name in census:
            if census[name]["type"] != typ:
                type_conflicts.setdefault(
                    name, {census[name]["type"]}).add(typ)
        else:
            census[name] = {"type": typ, "labels": set(), "renderer": site,
                            "backings": []}
    render_modules = {mod for _n, _t, _s, mod in sink.type_decls}
    untyped: dict[str, str] = {}
    for s in sink.samples:
        base = s["name"]
        if base not in census:
            for suf in _HIST_SUFFIXES:
                if base.endswith(suf) and base[:-len(suf)] in census:
                    base = base[:-len(suf)]
                    break
        if base not in census:
            untyped.setdefault(s["name"], s["site"])
            continue
        for ln, _src in s["labels"]:
            if ln != "le":
                census[base]["labels"].add(ln)
        if s["backing"]:
            census[base]["backings"].append(s["backing"])

    # consumers: scrape strings + registry refs outside renderers --------
    def _normalize(name: str) -> str:
        if name in census:
            return name
        for suf in _HIST_SUFFIXES:
            if name.endswith(suf) and name[:-len(suf)] in census:
                return name[:-len(suf)]
        return name

    consumers: dict[str, set] = {}
    consumers_prefix: dict[str, set] = {}
    for name, wildcard, site in sink.raw_consumers:
        if wildcard:
            consumers_prefix.setdefault(name, set()).add(site)
        else:
            consumers.setdefault(_normalize(name), set()).add(site)
    for modname, lit, site in sink.dotted_refs:
        if modname in render_modules:
            continue
        consumers.setdefault(_normalize(lit), set()).add(site)

    facts = {
        "metrics": {
            name: {
                "type": info["type"],
                "labels": sorted(info["labels"]),
                "renderer": info["renderer"],
            }
            for name, info in sorted(census.items())
        },
        "consumers": {n: sorted(s) for n, s in sorted(consumers.items())},
        "consumers_prefix": {n: sorted(s) for n, s
                             in sorted(consumers_prefix.items())},
        "engine": _engine_facts(index, classmap, sink),
    }

    intrinsic = _intrinsic_findings(
        index, classmap, sink, census, type_conflicts, untyped)
    return facts, intrinsic


def _intrinsic_findings(index, classmap, sink: _Sink, census,
                        type_conflicts, untyped) -> list:
    findings: list[MetricFinding] = []

    # ---- MT004: name/TYPE conventions ---------------------------------
    for name, types in sorted(type_conflicts.items()):
        findings.append(MetricFinding(
            name, "MT004", "type-conflict",
            f"conflicting TYPE declarations: {sorted(types)}"))
    for name, site in sorted(untyped.items()):
        findings.append(MetricFinding(
            name, "MT004", "missing-type",
            f"sample rendered at {site} with no # TYPE declaration"))
    for name, info in sorted(census.items()):
        if info["type"] == "counter" and not name.endswith("_total"):
            findings.append(MetricFinding(
                name, "MT004", "counter-name",
                "counter does not end in _total — scrapers derive rates "
                "from the suffix convention"))
        if (info["type"] == "histogram"
                and not name.endswith(("_seconds", "_bytes"))):
            findings.append(MetricFinding(
                name, "MT004", "histogram-units",
                "histogram name lacks a base-unit suffix "
                "(_seconds/_bytes per Prometheus conventions)"))

    # ---- MT004 c3/c5 + MT001 attr census via backing classes ----------
    producer_classes: set[str] = set()
    for info in census.values():
        for cls_key, _attr in info["backings"]:
            producer_classes.add(cls_key)
    for cls_key, _method in sink.dict_surfaces:
        producer_classes.add(cls_key)

    backing_by_class: dict[str, dict[str, list[str]]] = {}
    for name, info in census.items():
        for cls_key, attr in info["backings"]:
            backing_by_class.setdefault(cls_key, {}).setdefault(
                attr, []).append(name)

    attr_reads: set[str] = set()
    for modname, ctx in index.modules.items():
        p = ctx.path.as_posix() if hasattr(ctx.path, "as_posix") \
            else str(ctx.path)
        if not _producer_scope(p):
            continue
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
                attr_reads.add(n.attr)

    for cls_key in sorted(producer_classes):
        entry = classmap.get(cls_key)
        if entry is None:
            continue
        modpath, node = entry
        dec, assigned = _mutation_profile(node)
        short = cls_key.split(".")[-1]
        for attr, names in sorted(backing_by_class.get(cls_key, {}).items()):
            for name in sorted(set(names)):
                if census[name]["type"] != "counter":
                    continue
                if attr in dec:
                    findings.append(MetricFinding(
                        name, "MT004", "decremented-counter",
                        f"backed by {short}.{attr} which is decremented — "
                        "counters must be monotone (use a gauge)"))
                if attr in assigned:
                    findings.append(MetricFinding(
                        name, "MT004", "assigned-counter",
                        f"backed by {short}.{attr} which is plainly "
                        "re-assigned outside reset/__init__ — counters "
                        "must be monotone (use a gauge)"))
        # MT001 attr level: reset()-declared state nothing reads
        for attr, lineno in sorted(_reset_attrs(node).items()):
            if attr not in attr_reads:
                findings.append(MetricFinding(
                    short, "MT001", attr,
                    f"recorded at {modpath}:{lineno} but never read by "
                    "any renderer or in-tree consumer"))

    # ---- MT001 dict-surface level -------------------------------------
    for cls_key, method in sorted(sink.dict_surfaces):
        short = cls_key.split(".")[-1]
        for key, site in sorted(
                _surface_keys(classmap, cls_key, method).items()):
            if key not in sink.consumed_keys:
                findings.append(MetricFinding(
                    f"{short}.{method}", "MT001", key,
                    f"surfaced at {site} but no constant-key read "
                    "consumes it"))

    # ---- MT003: per-request identity in label values ------------------
    seen_mt003: set[tuple[str, str]] = set()
    for s in sink.samples:
        base = s["name"]
        if base not in census:
            for suf in _HIST_SUFFIXES:
                if base.endswith(suf) and base[:-len(suf)] in census:
                    base = base[:-len(suf)]
                    break
        for ln, src in s["labels"]:
            if src is None:
                continue
            idents = set(_NAME_RUN_RE.findall(src))
            bad = [t for t in _CARDINALITY_TOKENS
                   if any(t in i for i in idents)]
            if bad and (base, ln) not in seen_mt003:
                seen_mt003.add((base, ln))
                findings.append(MetricFinding(
                    base, "MT003", ln,
                    f"label value `{src}` at {s['site']} flows from "
                    f"per-request identity ({', '.join(bad)}) — "
                    "unbounded cardinality"))
    return sorted(findings)


def census_snapshot(facts: dict) -> dict:
    """The committed shape: name -> {type, labels} (no line numbers, so
    the manifest doesn't churn on unrelated edits)."""
    return {
        name: {"type": info["type"], "labels": list(info["labels"])}
        for name, info in facts["metrics"].items()
    }


# ------------------------------------------------------------------ check ----


def check_metric_facts(facts: dict, manifest: "MetricsManifest", intrinsic: list, *,
                       registry: Optional[dict] = None,
                       docs_text: Optional[str] = None,
                       drift: bool = True) -> list:
    """Combine intrinsic findings with the cross-checks that need the
    committed manifest: MT002 (consumer vs census) and MT005 (census vs
    manifest / registry SCHEMA / the port's generated docs table)."""
    findings = list(intrinsic)
    metrics = facts["metrics"]

    for name, sites in facts["consumers"].items():
        if name in metrics:
            continue
        for site in sites:
            findings.append(MetricFinding(
                name, "MT002", site,
                f"scraped at {site} but no renderer emits this metric — "
                "a renamed or dropped series silently zeroes this "
                "consumer"))
    for prefix, sites in facts["consumers_prefix"].items():
        if any(m.startswith(prefix) for m in metrics):
            continue
        for site in sites:
            findings.append(MetricFinding(
                prefix + "*", "MT002", site,
                f"prefix-scraped at {site} but no rendered metric "
                "starts with this prefix"))
    engine = facts.get("engine") or {}
    ekeys = set(engine.get("keys") or [])
    if ekeys:
        for key, sites in (engine.get("consumers") or {}).items():
            if key in ekeys:
                continue
            for site in sites:
                findings.append(MetricFinding(
                    f"EngineCore.metrics:{key}", "MT002", site,
                    f"read at {site} but EngineCore.metrics() never "
                    "sets this key"))

    if drift:
        committed = manifest.entrypoints or {}
        if committed:
            for name in sorted(set(metrics) - set(committed)):
                findings.append(MetricFinding(
                    name, "MT005", "added",
                    "rendered but absent from the committed census — "
                    "run --metrics --update-baseline"))
            for name in sorted(set(committed) - set(metrics)):
                findings.append(MetricFinding(
                    name, "MT005", "removed",
                    "in the committed census but no longer rendered — "
                    "run --metrics --update-baseline"))
            for name in sorted(set(metrics) & set(committed)):
                cur, old = metrics[name], committed[name]
                if cur["type"] != old.get("type"):
                    findings.append(MetricFinding(
                        name, "MT005", "type",
                        f"TYPE drifted: {old.get('type')} -> "
                        f"{cur['type']}"))
                if sorted(cur["labels"]) != sorted(old.get("labels") or []):
                    findings.append(MetricFinding(
                        name, "MT005", "labels",
                        f"label set drifted: {sorted(old.get('labels') or [])}"
                        f" -> {sorted(cur['labels'])}"))

    if registry is not None:
        for name in sorted(set(metrics) - set(registry)):
            findings.append(MetricFinding(
                name, "MT005", "registry-missing",
                "rendered but absent from obs/metric_names.SCHEMA"))
        for name in sorted(set(registry) - set(metrics)):
            findings.append(MetricFinding(
                name, "MT005", "registry-unrendered",
                "declared in obs/metric_names.SCHEMA but never rendered"))
        for name in sorted(set(metrics) & set(registry)):
            rtyp, rlabels = registry[name]
            if metrics[name]["type"] != rtyp:
                findings.append(MetricFinding(
                    name, "MT005", "registry-type",
                    f"SCHEMA says {rtyp}, renderer declares "
                    f"{metrics[name]['type']}"))
            if sorted(metrics[name]["labels"]) != sorted(rlabels):
                findings.append(MetricFinding(
                    name, "MT005", "registry-labels",
                    f"SCHEMA labels {sorted(rlabels)} != rendered "
                    f"{sorted(metrics[name]['labels'])}"))

    if docs_text is not None:
        expected = render_docs_table(metrics)
        actual = _docs_table_section(docs_text)
        if actual is None:
            findings.append(MetricFinding(
                DOCS_PATH.as_posix(), "MT005", "docs-markers",
                f"missing {DOCS_BEGIN} / {DOCS_END} markers around the "
                "metric reference table"))
        elif actual.strip() != expected.strip():
            findings.append(MetricFinding(
                DOCS_PATH.as_posix(), "MT005", "docs-table",
                "metric reference table drifted from the census — "
                "regenerate with "
                "`python -m dynamo_tpu_torch lint --metrics --update-baseline`"))
    return sorted(findings)


# ------------------------------------------------------------------- docs ----

DOCS_BEGIN = "<!-- metcheck:begin -->"
DOCS_END = "<!-- metcheck:end -->"


def render_docs_table(metrics: dict) -> str:
    """The generated metric reference table (between the metcheck
    markers in docs/torch_observability.md)."""
    lines = ["| metric | type | labels |", "| --- | --- | --- |"]
    for name in sorted(metrics):
        info = metrics[name]
        labels = ", ".join(info["labels"]) if info["labels"] else "-"
        lines.append(f"| `{name}` | {info['type']} | {labels} |")
    return "\n".join(lines) + "\n"


def _docs_table_section(text: str) -> Optional[str]:
    if DOCS_BEGIN not in text or DOCS_END not in text:
        return None
    return text.split(DOCS_BEGIN, 1)[1].split(DOCS_END, 1)[0]


def _write_docs_table(root: Path, metrics: dict) -> bool:
    path = root / DOCS_PATH
    if not path.is_file():
        return False
    text = path.read_text()
    if DOCS_BEGIN not in text or DOCS_END not in text:
        return False
    head, rest = text.split(DOCS_BEGIN, 1)
    _old, tail = rest.split(DOCS_END, 1)
    path.write_text(
        head + DOCS_BEGIN + "\n" + render_docs_table(metrics)
        + DOCS_END + tail)
    return True


# -------------------------------------------------------------------- CLI ----

# paths whose changes can affect metrics-plane facts (for `--changed`)
_TOUCHES = (
    "dynamo_tpu_torch/obs/",
    "dynamo_tpu_torch/engine/counters.py",
    "dynamo_tpu_torch/engine/core.py",
    "dynamo_tpu_torch/fault/counters.py",
    "dynamo_tpu_torch/llm/http/metrics.py",
    "dynamo_tpu_torch/llm/kv/stream.py",
    "dynamo_tpu_torch/llm/kv_router/shards/",
    "dynamo_tpu_torch/components/metrics.py",
    "dynamo_tpu_torch/analysis/metcheck.py",
    "dynamo_tpu_torch/analysis/metrics_manifest.json",
    "docs/torch_observability.md",
    "tests/test_torch_",
    "chip_smoke.py",
)


def _metrics_affected(root: Path) -> bool:
    from dynamo_tpu_torch.analysis.cli import _git_changed_paths

    dirty = [str(p) for p in _git_changed_paths(root, suffixes=(".py", ".json", ".md"))]
    return any(frag in d for d in dirty for frag in _TOUCHES)


def _met_header() -> dict:
    return {
        "note": (
            "Static producer->renderer->scraper census of the /metrics "
            "surface (dtmet plane). Entrypoints are metric names with "
            "their declared TYPE and label schema; accepted entries are "
            "justified deviations from the MT conventions."
        ),
    }


def run_metrics(args, out) -> int:
    """``python -m dynamo_tpu_torch lint --metrics``: extract the metrics
    census, diff against the committed metrics manifest / registry
    SCHEMA / the port's docs table, exit 1 on any non-accepted finding.
    ``--update-baseline`` re-snapshots the census and regenerates the
    table in docs/torch_observability.md (and writes no other file)."""
    manifest_path = Path(
        getattr(args, "manifest", None) or DEFAULT_METRICS_MANIFEST_PATH)
    manifest = MetricsManifest.load(manifest_path)
    root = Path(getattr(args, "root", None)
                or Path(__file__).resolve().parents[2])
    if getattr(args, "changed", False) and not _metrics_affected(root):
        print("metrics plane unaffected by changed files", file=out)
        return 0

    facts, intrinsic = collect_metric_facts(root=root)
    from dynamo_tpu_torch.obs import metric_names

    registry = {name: (typ, list(labels))
                for name, (typ, labels) in metric_names.SCHEMA.items()}
    docs_path = root / DOCS_PATH
    docs_text = docs_path.read_text() if docs_path.is_file() else None

    if getattr(args, "update_baseline", False):
        _write_docs_table(root, facts["metrics"])
        docs_text = docs_path.read_text() if docs_path.is_file() else None
        findings = check_metric_facts(
            facts, manifest, intrinsic, registry=registry,
            docs_text=docs_text, drift=False)
        accepted = [f for f in findings if f.rule != "MT005"]
        m = MetricsManifest.from_facts(census_snapshot(facts), accepted,
                                       manifest)
        m.header = manifest.header or _met_header()
        m.save(manifest_path)
        print(
            f"metrics manifest updated: {len(facts['metrics'])} metrics, "
            f"{len(accepted)} accepted finding"
            f"{'' if len(accepted) == 1 else 's'} -> {manifest_path}",
            file=out,
        )
        return 0

    findings = check_metric_facts(
        facts, manifest, intrinsic, registry=registry,
        docs_text=docs_text, drift=True)
    fresh = manifest.filter(findings)
    n_accepted = len(findings) - len(fresh)
    if getattr(args, "fmt", "text") == "json":
        doc = {
            "findings": [f.to_json() for f in fresh],
            "accepted": n_accepted,
            "total": len(findings),
            "metrics": len(facts["metrics"]),
            "consumers": sum(
                len(s) for s in facts["consumers"].values()),
        }
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        for f in fresh:
            print(f.render(), file=out)
        print(
            f"{len(fresh)} metrics finding"
            f"{'s' if len(fresh) != 1 else ''} ({n_accepted} accepted) "
            f"over {len(facts['metrics'])} metrics",
            file=out,
        )
    return 1 if fresh else 0
