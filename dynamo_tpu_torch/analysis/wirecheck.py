"""Wire-plane static analysis (dtwire) over the port: extracted message
contracts.

The counterpart of the JAX package's ``analysis/wirecheck.py``: the same
producers, consumers, channels and rules WR001-WR007, over the port's
``core.py`` and ``project.py`` and the port's own wire modules
(``dynamo_tpu_torch.runtime.transports.{framing,coordinator,tcp}``,
``llm.kv.{transfer,persist}``, ``llm.kv_router`` and its shard wire, the
fault plane, the planner and the components), against the port's own
committed ``analysis/wire_manifest.json``.

Coordinator KV/blob commands, TCP endpoint frames, router KV events,
KV-block transfer ops, ``DTKVP1`` persist headers and planner prewarm
hints are all stringly-typed dicts whose producer and consumer live in
different functions (often different modules) and drift silently until
a runtime ``KeyError``.  This pass extracts every cross-process message
contract from the code itself, over the same ``ProjectIndex`` the
interprocedural pass builds (one ``ast.parse`` per file, shared through
``core.parse_module``):

- **producers** — dict literals flowing into a framing/JSON sink
  (``write_frame``/``encode_frame`` header positions, ``json.dumps``,
  ``publish(subject, payload)``, durable WAL/``kv_put`` writes), found
  through a fixpoint over function parameters that reach a sink, plus
  conditional ``d["k"] = v`` augmentations (always vs maybe keys) and
  literal discriminator domains resolved through module/class string
  constants (``CoordOp.KV_PUT`` -> ``"kv_put"``);
- **consumers** — dict roots born from ``read_frame`` unpacks, RPC
  round-trip returns, ``subscribe`` callback payloads and
  ``json.loads``, profiled for reads (``h["k"]`` required,
  ``h.get("k")`` optional, ``"k" in h`` guards), discriminator dispatch
  (``if op == ...: / elif``) tagging reads per variant, and opaque
  ``Cls(**d)`` destructuring.

Producer and consumer sites meet on a *channel* — ``module:<mod>``,
``subject:<normalized subject>`` or ``kv:<key>``, split by
discriminator key — and the rules run per channel:

  WR001  field written by a producer but read by no consumer
  WR002  field read without a default but not written by every producer
  WR003  discriminator drift: emitted value no dispatch handles (or a
         dispatch arm for a value no producer emits)
  WR004  persisted / cross-replica payload missing a version tag
  WR005  non-JSON-safe value (bytes, a numpy or torch scalar or tensor,
         struct.pack) flowing into ``json.dumps`` via local dataflow
  WR006  framing write reachable after a close/abort of the same
         writer (static twin of the sanitizer's FramingGuard)
  WR007  schema drift against the committed wire manifest

Channel facts snapshot into ``analysis/wire_manifest.json`` with an
accepted/justification/``--update-baseline`` contract:
``python -m dynamo_tpu_torch lint --wire`` exits 1 on any non-accepted
finding, and any schema change is an explicit, reviewed manifest diff.
A channel's schema hash covers its key census, discriminator domains
and version tagging, not its module name, so the port's hash of a
channel equals the JAX package's wherever the two codes agree.

Extraction is deliberately heuristic: it resolves local dataflow one or
two hops, not arbitrary aliasing, and channels with no extracted
consumer *and* no durability are dropped rather than guessed at.
"""

from __future__ import annotations

import ast
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

from dynamo_tpu_torch.analysis.core import dotted_name, iter_python_files
from dynamo_tpu_torch.analysis.project import (
    FunctionInfo,
    ProjectIndex,
    _classify_call,
)

__all__ = [
    "DEFAULT_WIRE_MANIFEST_PATH",
    "WIRE_RULES",
    "WireFinding",
    "WireManifest",
    "collect_wire_facts",
    "check_wire",
    "run_wire",
]

DEFAULT_WIRE_MANIFEST_PATH = Path(__file__).parent / "wire_manifest.json"

WIRE_RULES = {
    "WR001": ("dead-wire-field",
              "field written by a producer but read by no consumer"),
    "WR002": ("latent-keyerror",
              "field read with no default but not written by every "
              "producer of the message"),
    "WR003": ("discriminator-drift",
              "discriminator value emitted that no consumer dispatch "
              "handles, or handled but never emitted"),
    "WR004": ("unversioned-payload",
              "persisted or cross-replica payload missing a "
              "version/generation tag"),
    "WR005": ("json-unsafe-value",
              "non-JSON-safe value (bytes / numpy or torch scalar or "
              "tensor) flowing into json.dumps"),
    "WR006": ("write-after-close",
              "framing write reachable after a close/abort of the "
              "same writer"),
    "WR007": ("schema-drift",
              "extracted message schema changed vs the committed "
              "wire manifest"),
}

# package-relative directories the wire plane lives in (the default
# scan scope; explicit paths override, e.g. for fixtures)
WIRE_SCOPE_DIRS = (
    "runtime", "llm/kv", "llm/kv_router", "fault", "planner",
    "components",
)

# channel discriminator keys, in priority order
DISC_KEYS = ("op", "type", "kind", "t")
# keys whose literal value domains are recorded (discriminators plus
# the router event tier tag)
DOMAIN_KEYS = DISC_KEYS + ("tier",)
# any of these keys on a durable payload counts as a version tag
VERSION_KEYS = frozenset({
    "version", "format_version", "generation", "epoch", "v", "schema",
})

_MANIFEST_NOTE = (
    "AST-extracted wire contracts (analysis/wirecheck.py): channel = "
    "producer/consumer meeting point keyed by module, pub/sub subject "
    "or kv key, split by discriminator. Schema hashes cover key census "
    "+ discriminator domains + version tagging; producer/consumer "
    "counts are informational only. Extraction is heuristic: local "
    "dataflow one or two hops, no arbitrary aliasing."
)


# ---------------------------------------------------------------- findings ----


@dataclass(frozen=True, order=True)
class WireFinding:
    """One wire-plane finding.  ``(message, rule, key)`` is the stable
    acceptance key, the way (entrypoint, rule, key) works for trace
    findings — line numbers are deliberately absent so accepted entries
    survive unrelated edits."""

    message: str   # channel name, e.g. "module:<package>.runtime.transports.tcp/type"
    rule: str
    key: str
    detail: str

    @property
    def accept_key(self) -> tuple[str, str, str]:
        return (self.message, self.rule, self.key)

    def render(self) -> str:
        return f"{self.message}: {self.rule}[{self.key}] {self.detail}"

    def to_json(self) -> dict:
        return {
            "message": self.message,
            "rule": self.rule,
            "key": self.key,
            "detail": self.detail,
        }


# ---------------------------------------------------------------- manifest ----


class WireManifest:
    """Committed wire-plane snapshot + accepted (justified) findings.

    The JAX package's manifest contract: ``accepted`` entries carry a
    one-line justification and are matched as a (message, rule, key)
    multiset; ``--update-baseline`` (with ``--wire``) re-snapshots the
    message facts and carries justifications over where the key still
    matches."""

    def __init__(self, messages: Optional[dict] = None,
                 accepted: Optional[list[dict]] = None,
                 header: Optional[dict] = None):
        self.messages: dict = messages or {}
        self.accepted: list[dict] = accepted or []
        self.header: dict = header or {}

    @classmethod
    def load(cls, path: Path) -> "WireManifest":
        if not Path(path).is_file():
            return cls()
        data = json.loads(Path(path).read_text())
        return cls(dict(data.get("messages", {})),
                   list(data.get("accepted", [])),
                   dict(data.get("header", {})))

    def save(self, path: Path) -> None:
        doc = {
            "version": 1,
            "header": self.header or {"note": _MANIFEST_NOTE},
            "messages": self.messages,
            "accepted": sorted(
                self.accepted,
                key=lambda e: (e["message"], e["rule"], e["key"]),
            ),
        }
        Path(path).write_text(
            json.dumps(doc, indent=2, sort_keys=True) + "\n"
        )

    def _counts(self) -> dict[tuple[str, str, str], int]:
        counts: dict[tuple[str, str, str], int] = {}
        for e in self.accepted:
            key = (e["message"], e["rule"], e["key"])
            counts[key] = counts.get(key, 0) + 1
        return counts

    def filter(self, findings: list[WireFinding]) -> list[WireFinding]:
        """Findings NOT covered by an accepted entry (stable-sorted)."""
        budget = self._counts()
        fresh: list[WireFinding] = []
        for f in sorted(findings):
            if budget.get(f.accept_key, 0) > 0:
                budget[f.accept_key] -= 1
            else:
                fresh.append(f)
        return fresh

    @classmethod
    def from_facts(cls, facts: dict, findings: list[WireFinding],
                   previous: "WireManifest") -> "WireManifest":
        """Re-snapshot: current channel facts become the committed
        messages; intrinsic findings become accepted entries, carrying
        the previous justification where the key still matches."""
        just: dict[tuple[str, str, str], list[str]] = {}
        for e in previous.accepted:
            key = (e["message"], e["rule"], e["key"])
            just.setdefault(key, []).append(e.get("justification", ""))
        accepted = []
        for f in sorted(findings):
            carried = just.get(f.accept_key)
            accepted.append({
                "message": f.message,
                "rule": f.rule,
                "key": f.key,
                "detail": f.detail,
                "justification": (
                    carried.pop(0) if carried else "TODO: justify"
                ),
            })
        return cls(facts, accepted, previous.header or None)


# ---------------------------------------------------- literal resolution ----


def _const_table(index: ProjectIndex) -> dict[str, str]:
    """Dotted name -> string literal, over every module's top-level and
    class-level ``NAME = "lit"`` assignments.  Cross-module references
    resolve through each module's import table (ctx.canonical), so
    ``CoordOp.KV_PUT`` bottoms out at its literal wherever it is used."""
    consts: dict[str, str] = {}
    for modname, ctx in index.modules.items():
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Constant) and isinstance(
                    node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        consts[f"{modname}.{t.id}"] = node.value.value
            elif isinstance(node, ast.ClassDef):
                for s in node.body:
                    if isinstance(s, ast.Assign) and isinstance(
                            s.value, ast.Constant) and isinstance(
                            s.value.value, str):
                        for t in s.targets:
                            if isinstance(t, ast.Name):
                                consts[
                                    f"{modname}.{node.name}.{t.id}"
                                ] = s.value.value
    return consts


def _lit_values(expr: ast.AST, ctx, modname: str,
                consts: dict[str, str]) -> list[str]:
    """Possible string values of ``expr``; "?" marks unresolvable."""
    if isinstance(expr, ast.Constant):
        return [expr.value] if isinstance(expr.value, str) else ["?"]
    if isinstance(expr, ast.IfExp):
        return (_lit_values(expr.body, ctx, modname, consts)
                + _lit_values(expr.orelse, ctx, modname, consts))
    raw = dotted_name(expr)
    if raw:
        for cand in (ctx.canonical(raw), f"{modname}.{raw}"):
            if cand in consts:
                return [consts[cand]]
    return ["?"]


def _param_names(fn_node) -> list[str]:
    a = fn_node.args
    return [p.arg for p in (list(a.posonlyargs) + list(a.args))]


def _root_name(expr: ast.AST) -> Optional[str]:
    """Name a dict-valued expression is rooted in: a bare ``Name`` or
    the first arg of a ``dict(name, ...)`` rebuild."""
    if isinstance(expr, ast.Name):
        return expr.id
    if (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
            and expr.func.id == "dict" and expr.args
            and isinstance(expr.args[0], ast.Name)):
        return expr.args[0].id
    return None


def _unwrap_async(expr: ast.AST) -> ast.AST:
    """Strip Await and asyncio.wait_for wrappers."""
    while True:
        if isinstance(expr, ast.Await):
            expr = expr.value
            continue
        if isinstance(expr, ast.Call):
            raw = dotted_name(expr.func)
            if raw and raw.rsplit(".", 1)[-1] == "wait_for" and expr.args:
                expr = expr.args[0]
                continue
        return expr


def _normalize_subject(expr, fn_node, ctx, index=None, cls=None,
                       depth=0) -> str:
    """Stable label for a pub/sub subject (or kv key) expression: the
    helper-function leaf name (``events_subject(...)`` ->
    "events_subject"), an f-string with holes as "*", a literal, or a
    one/two-hop local / self-attribute resolution of either."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.JoinedStr):
        parts = []
        for v in expr.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("*")
        return "".join(parts)
    if isinstance(expr, ast.Call):
        raw = dotted_name(expr.func)
        return raw.rsplit(".", 1)[-1] if raw else "?"
    if isinstance(expr, ast.Name) and fn_node is not None and depth < 3:
        for st in ast.walk(fn_node):
            if (isinstance(st, ast.Assign) and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)
                    and st.targets[0].id == expr.id):
                return _normalize_subject(st.value, fn_node, ctx, index,
                                          cls, depth + 1)
        return f"?{expr.id}"
    if isinstance(expr, ast.Attribute) and depth < 3:
        raw = dotted_name(expr)
        if raw.startswith("self.") and cls is not None and index is not None:
            attr = raw.split(".", 1)[1]
            ci = index.classes.get(cls)
            if ci:
                for m in ci.methods.values():
                    if m.node is None:
                        continue
                    for st in ast.walk(m.node):
                        if (isinstance(st, ast.Assign)
                                and len(st.targets) == 1
                                and isinstance(st.targets[0], ast.Attribute)
                                and isinstance(st.targets[0].value, ast.Name)
                                and st.targets[0].value.id == "self"
                                and st.targets[0].attr == attr):
                            return _normalize_subject(
                                st.value, m.node, ctx, index, cls,
                                depth + 1)
        return f"?{raw or 'attr'}"
    return "?"


# ------------------------------------------------------- dict key census ----


def _dict_keys(d: ast.Dict, ctx, modname, consts):
    """(keys {k: "always"}, domains {k: set of values}, opaque) for one
    dict literal.  ``**expansion`` or a non-literal key -> opaque."""
    keys: dict[str, str] = {}
    domains: dict[str, set] = {}
    opaque = False
    for k, v in zip(d.keys, d.values):
        if k is None:
            opaque = True
            continue
        names = [x for x in _lit_values(k, ctx, modname, consts)
                 if x != "?"]
        if not names:
            opaque = True
            continue
        for name in names:
            keys[name] = "always"
            if name in DOMAIN_KEYS:
                domains.setdefault(name, set()).update(
                    _lit_values(v, ctx, modname, consts))
    return keys, domains, opaque


def _dict_augments(body, varname, ctx, modname, consts, keys, domains,
                   cond=False):
    """Fold ``varname["k"] = v`` assignments under ``body`` into the
    key census: unconditional -> always, under a branch -> maybe, and
    if-with-else assigning the same key in both arms -> always."""
    for st in body:
        if isinstance(st, ast.Assign):
            for t in st.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == varname
                        and isinstance(t.slice, ast.Constant)
                        and isinstance(t.slice.value, str)):
                    k = t.slice.value
                    mode = "maybe" if cond else "always"
                    if keys.get(k) != "always":
                        keys[k] = mode
                    if k in DOMAIN_KEYS:
                        domains.setdefault(k, set()).update(
                            _lit_values(st.value, ctx, modname, consts))
        elif isinstance(st, ast.If):
            bk: dict[str, str] = {}
            ok: dict[str, str] = {}
            _dict_augments(st.body, varname, ctx, modname, consts,
                           bk, domains, cond=False)
            _dict_augments(st.orelse, varname, ctx, modname, consts,
                           ok, domains, cond=False)
            for k in set(bk) | set(ok):
                both = bk.get(k) == "always" and ok.get(k) == "always"
                mode = "always" if (both and not cond) else "maybe"
                if keys.get(k) != "always":
                    keys[k] = mode
        elif isinstance(st, (ast.For, ast.AsyncFor, ast.While, ast.Try,
                             ast.With, ast.AsyncWith)):
            for attr in ("body", "orelse", "finalbody"):
                _dict_augments(getattr(st, attr, []) or [], varname,
                               ctx, modname, consts, keys, domains,
                               cond=True)
            for h in getattr(st, "handlers", []) or []:
                _dict_augments(h.body, varname, ctx, modname, consts,
                               keys, domains, cond=True)


# ------------------------------------------------------------- site model ----


@dataclass
class _Producer:
    module: str
    base: str                       # channel base ("module:...", "subject:...")
    keys: dict                      # key -> "always" | "maybe"
    domains: dict                   # DOMAIN key -> set of values ("?" possible)
    opaque: bool = False
    durable: bool = False


@dataclass
class _Profile:
    """Read profile of one dict root (a function param or local)."""

    reads: set = field(default_factory=set)   # (key, required, tags)
    domain: set = field(default_factory=set)  # consumed discriminator values
    discs: set = field(default_factory=set)   # discriminator keys seen
    opaque: bool = False                      # Cls(**root) somewhere
    open_dispatch: bool = False               # dispatch has a terminal else

    @property
    def disc(self) -> Optional[str]:
        for k in DISC_KEYS:
            if k in self.discs:
                return k
        return None

    @property
    def empty(self) -> bool:
        return not (self.reads or self.domain or self.opaque)

    def merge(self, other: "_Profile", outer_tags: frozenset) -> None:
        for key, req, tags in other.reads:
            self.reads.add((key, req, tags if tags else outer_tags))
        self.domain |= other.domain
        self.discs |= other.discs
        self.opaque = self.opaque or other.opaque
        self.open_dispatch = self.open_dispatch or other.open_dispatch


@dataclass
class _Consumer:
    module: str
    base: str
    profile: _Profile


# ------------------------------------------------------------ read walker ----


class _ReadWalker:
    """Collect the read profile of dict ``root`` in one function body:
    required/optional key reads, membership guards, discriminator
    aliasing and if/elif dispatch tagging, ``Cls(**root)`` opacity, and
    one-level propagation into callees taking the root positionally."""

    def __init__(self, ext: "_Extractor", fn: FunctionInfo, ctx,
                 root: str, profile: _Profile, depth: int = 0):
        self.ext = ext
        self.fn = fn
        self.ctx = ctx
        self.root = root
        self.p = profile
        self.depth = depth
        self.aliases: dict[str, str] = {}    # local name -> disc key
        # locals that ARE the root's payload (d = json.loads(root)):
        # the decode-helper idiom, where the raw bytes arrive as a
        # param and every key read happens on the parsed local
        self.loads_roots: set[str] = set()

    # ------------------------------------------------------------ plumbing
    def run(self, body, tags=frozenset(), guarded=frozenset()):
        for st in body:
            self.stmt(st, tags, guarded)

    def stmt(self, st, tags, guarded):
        if isinstance(st, ast.If):
            newtags, guards, is_disc = self.analyze_test(st.test)
            self.expr_scan(st.test, tags, guarded)
            self.run(st.body, newtags if is_disc else tags,
                     guarded | guards)
            if st.orelse:
                if (is_disc and len(st.orelse) == 1
                        and isinstance(st.orelse[0], ast.If)):
                    self.stmt(st.orelse[0], tags, guarded)  # elif chain
                elif is_disc:
                    self.p.open_dispatch = True
                    self.run(st.orelse, frozenset({"~else"}), guarded)
                else:
                    self.run(st.orelse, tags, guarded)
            return
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # default-arg expressions evaluate at def time, under the
            # enclosing dispatch arm (the `async def _pull(q=h["queue"])`
            # idiom) — scan them with the CURRENT tags
            for d in list(st.args.defaults) + [
                    x for x in st.args.kw_defaults if x is not None]:
                self.expr_scan(d, tags, guarded)
            if self.root not in _param_names(st):   # not shadowed
                self.run(st.body, frozenset(), guarded)
            return
        if isinstance(st, (ast.For, ast.AsyncFor, ast.While, ast.Try,
                           ast.With, ast.AsyncWith)):
            for attr in ("iter", "test"):
                sub = getattr(st, attr, None)
                if sub is not None:
                    self.expr_scan(sub, tags, guarded)
            for item in getattr(st, "items", []) or []:
                self.expr_scan(item.context_expr, tags, guarded)
            for attr in ("body", "orelse", "finalbody"):
                self.run(getattr(st, attr, []) or [], tags, guarded)
            for h in getattr(st, "handlers", []) or []:
                self.run(h.body, tags, guarded)
            return
        if isinstance(st, ast.Assign):
            self.handle_assign(st, tags, guarded)
            return
        self.expr_scan(st, tags, guarded)

    # ------------------------------------------------------------- pieces
    def is_root(self, expr) -> bool:
        return isinstance(expr, ast.Name) and (
            expr.id == self.root or expr.id in self.loads_roots)

    def read_key_of(self, expr):
        """("key", required) if expr reads one key off the root."""
        if (isinstance(expr, ast.Subscript) and self.is_root(expr.value)
                and isinstance(expr.slice, ast.Constant)
                and isinstance(expr.slice.value, str)
                and isinstance(expr.ctx, ast.Load)):
            return expr.slice.value, True
        if (isinstance(expr, ast.Call)
                and isinstance(expr.func, ast.Attribute)
                and expr.func.attr in ("get", "pop")
                and self.is_root(expr.func.value)
                and expr.args
                and isinstance(expr.args[0], ast.Constant)
                and isinstance(expr.args[0].value, str)):
            return expr.args[0].value, False
        return None

    def disc_of(self, expr) -> Optional[str]:
        """Discriminator key this expression denotes, if any."""
        if isinstance(expr, ast.Name) and expr.id in self.aliases:
            return self.aliases[expr.id]
        got = self.read_key_of(expr)
        if got and got[0] in DISC_KEYS:
            return got[0]
        return None

    def record(self, key, required, tags, guarded):
        if key in guarded:
            required = False
        self.p.reads.add((key, required, tags))
        if key in DISC_KEYS:
            self.p.discs.add(key)

    def handle_assign(self, st, tags, guarded):
        target = st.targets[0] if len(st.targets) == 1 else None
        pairs = []
        if (isinstance(target, ast.Tuple) and isinstance(st.value, ast.Tuple)
                and len(target.elts) == len(st.value.elts)):
            pairs = list(zip(target.elts, st.value.elts))
        elif target is not None:
            pairs = [(target, st.value)]
        for t, v in pairs:
            got = self.read_key_of(v)
            if got and isinstance(t, ast.Name):
                key, _req = got
                if key in DISC_KEYS:
                    self.aliases[t.id] = key
                    self.p.discs.add(key)
            if (isinstance(t, ast.Name) and isinstance(v, ast.Call)
                    and self.ext.canon(v, self.ctx) == "json.loads"
                    and v.args and self.is_root(v.args[0])):
                self.loads_roots.add(t.id)
        self.expr_scan(st, tags, guarded)

    def analyze_test(self, test):
        """(variant tags, membership-guarded keys, is_disc_dispatch)"""
        tags: set = set()
        guards: set = set()

        def visit(t):
            if isinstance(t, ast.BoolOp):
                for v in t.values:
                    visit(v)
                return
            if not isinstance(t, ast.Compare) or len(t.ops) != 1:
                return
            op, left, right = t.ops[0], t.left, t.comparators[0]
            if isinstance(op, ast.Eq):
                disc = self.disc_of(left) or self.disc_of(right)
                lit = right if self.disc_of(left) else left
                if disc:
                    vals = _lit_values(lit, self.ctx, self.fn.module,
                                       self.ext.consts)
                    tags.update(vals)
                    self.p.domain.update(v for v in vals if v != "?")
                return
            if isinstance(op, ast.In):
                if (isinstance(left, ast.Constant)
                        and isinstance(left.value, str)
                        and self.is_root(right)):
                    guards.add(left.value)
                    return
                disc = self.disc_of(left)
                if disc and isinstance(right, (ast.Tuple, ast.List,
                                               ast.Set)):
                    for e in right.elts:
                        vals = _lit_values(e, self.ctx, self.fn.module,
                                           self.ext.consts)
                        tags.update(vals)
                        self.p.domain.update(
                            v for v in vals if v != "?")

        visit(test)
        return frozenset(tags), frozenset(guards), bool(tags)

    def expr_scan(self, node, tags, guarded):
        for n in ast.walk(node):
            got = self.read_key_of(n)
            if got:
                self.record(got[0], got[1], tags, guarded)
                continue
            if not isinstance(n, ast.Call):
                continue
            # dtspan envelope: tracing.extract(root) is an optional
            # read of the trace-context field off the header
            raw = dotted_name(n.func)
            if (raw.rsplit(".", 1)[-1] == "extract"
                    and "tracing" in raw
                    and n.args and self.is_root(n.args[0])):
                self.record("trace", False, tags, guarded)
            # consumed-domain contributions outside If tests handled by
            # analyze_test on the enclosing If; Compare nodes inside
            # expressions (return x == ...) are rare enough to skip.
            for kw in n.keywords:
                if kw.arg is None and self.is_root(kw.value):
                    self.p.opaque = True
            if self.depth < 2:
                for i, a in enumerate(n.args):
                    if self.is_root(a):
                        self.propagate(n, i, tags)

    def propagate(self, call, argidx, tags):
        """Merge the read profile of the callee param the root lands in."""
        site = _classify_call(call, self.ctx)
        if site is None:
            return
        for t in self.ext.index.resolve(site, self.fn):
            if t.node is None:
                continue
            params = _param_names(t.node)
            offset = 1 if (params and params[0] in ("self", "cls")
                           and site.kind in ("self", "attr")) else 0
            pi = argidx + offset
            if pi >= len(params):
                continue
            sub = self.ext.param_profile(t, params[pi],
                                         depth=self.depth + 1)
            self.p.merge(sub, tags)
            return


# -------------------------------------------------------------- extractor ----


class _Extractor:
    """One pass over the ProjectIndex: producer sites, consumer roots,
    and the site-level WR005/WR006 findings."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self.consts = _const_table(index)
        self.producers: list[_Producer] = []
        self.consumers: list[_Consumer] = []
        self.site_findings: list[WireFinding] = []
        self._profiles: dict[tuple[str, str], _Profile] = {}
        self.sink_params: set[tuple[str, str]] = set()
        # (qualname, param) pairs a tracing.inject() call stamps the
        # dtspan trace field onto before the frame is written
        self.inject_params: set[tuple[str, str]] = set()
        self.callback_channels: dict[tuple[str, str], str] = {}
        self.frame_returners: set[str] = set()
        self.dict_returners: set[str] = set()

    # ------------------------------------------------------------ helpers
    def canon(self, call: ast.Call, ctx) -> str:
        raw = dotted_name(call.func)
        return ctx.canonical(raw) if raw else ""

    def _local_assign(self, fn_node, name: str) -> Optional[ast.AST]:
        for st in ast.walk(fn_node):
            if (isinstance(st, ast.Assign) and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)
                    and st.targets[0].id == name):
                return st.value
        return None

    def _as_dict_source(self, expr, fn: FunctionInfo, ctx, depth=0):
        """Resolve an expression to a producible dict: returns
        (dict_node, varname, owner_fn_node, owner_ctx, owner_mod),
        the string "opaque", or None."""
        if depth > 3:
            return None
        if isinstance(expr, ast.Dict):
            return (expr, None, fn.node, ctx, fn.module)
        if isinstance(expr, ast.BinOp):     # json.dumps(...) + "\n"
            return (self._as_dict_source(expr.left, fn, ctx, depth + 1)
                    or self._as_dict_source(expr.right, fn, ctx,
                                            depth + 1))
        if isinstance(expr, ast.Call):
            canon = self.canon(expr, ctx)
            if (isinstance(expr.func, ast.Attribute)
                    and expr.func.attr == "encode"):
                return self._as_dict_source(expr.func.value, fn, ctx,
                                            depth + 1)
            if canon == "json.dumps" and expr.args:
                return self._as_dict_source(expr.args[0], fn, ctx,
                                            depth + 1)
            if canon.endswith("tracing.inject") and expr.args:
                # dtspan envelope: inject(h) returns the same header
                # with an optional trace-context field stamped on it —
                # unwrap so the underlying dict literal still resolves
                # (the caller tags the producer with the trace key)
                return self._as_dict_source(expr.args[0], fn, ctx,
                                            depth + 1)
            if canon.endswith("asdict") or any(
                    kw.arg is None for kw in expr.keywords):
                return "opaque"
            site = _classify_call(expr, ctx)
            if site is not None:
                for t in self.index.resolve(site, fn):
                    if t.node is None:
                        continue
                    tctx = self.index.modules.get(t.module)
                    if tctx is None:
                        continue
                    for st in ast.walk(t.node):
                        if (isinstance(st, ast.Return)
                                and st.value is not None):
                            v = st.value
                            if isinstance(v, ast.Dict):
                                return (v, None, t.node, tctx, t.module)
                            if isinstance(v, ast.Name):
                                d = self._local_assign(t.node, v.id)
                                if isinstance(d, ast.Dict):
                                    return (d, v.id, t.node, tctx,
                                            t.module)
                            if isinstance(v, (ast.Call, ast.BinOp)):
                                # encode-helper idiom: the target
                                # returns json.dumps({...}).encode()
                                sub = self._as_dict_source(
                                    v, t, tctx, depth + 1)
                                if isinstance(sub, tuple):
                                    return sub
            return "opaque"
        if isinstance(expr, ast.Name):
            a = self._local_assign(fn.node, expr.id)
            if isinstance(a, ast.Dict):
                return (a, expr.id, fn.node, ctx, fn.module)
            if a is not None and not isinstance(a, ast.Name):
                src = self._as_dict_source(a, fn, ctx, depth + 1)
                if isinstance(src, tuple):
                    # the local was built by a call returning a dict —
                    # caller-side augments (line["v"] = ... after
                    # line = make_header(...)) still apply; append an
                    # extra augment scope for add_producer to fold
                    return src + ((fn.node, expr.id, ctx, fn.module),)
                return src
        return None

    def add_producer(self, src, base: str, durable: bool,
                     fallback_module: str, injected: bool = False):
        if src == "opaque":
            self.producers.append(_Producer(
                fallback_module, base, {}, {}, opaque=True,
                durable=durable))
            return True
        if src is None:
            return False
        d, varname, owner_node, owner_ctx, owner_mod = src[:5]
        keys, domains, opaque = _dict_keys(d, owner_ctx, owner_mod,
                                           self.consts)
        if varname:
            _dict_augments(owner_node.body, varname, owner_ctx,
                           owner_mod, self.consts, keys, domains)
        for aug_node, aug_var, aug_ctx, aug_mod in src[5:]:
            _dict_augments(aug_node.body, aug_var, aug_ctx, aug_mod,
                           self.consts, keys, domains)
        if injected:
            # dtspan envelope: inject() stamps the trace context only
            # when tracing is enabled AND a span is active — maybe
            keys.setdefault("trace", "maybe")
        self.producers.append(_Producer(
            owner_mod, base, keys, domains, opaque=opaque,
            durable=durable))
        return True

    def param_profile(self, fn: FunctionInfo, param: str,
                      depth: int = 0) -> _Profile:
        key = (fn.qualname, param)
        hit = self._profiles.get(key)
        if hit is not None:
            return hit
        profile = _Profile()
        self._profiles[key] = profile        # recursion guard
        ctx = self.index.modules.get(fn.module)
        if ctx is not None and fn.node is not None:
            _ReadWalker(self, fn, ctx, param, profile,
                        depth=depth).run(fn.node.body)
        return profile

    # --------------------------------------------------------- sink fixpoint
    def _sink_arg_exprs(self, call: ast.Call, fn: FunctionInfo, ctx):
        """(expr, injected) pairs at header-sink positions of this
        call; ``injected`` marks headers a ``tracing.inject`` stamps
        the optional dtspan trace field onto en route to the wire."""
        out = []

        def is_inject(e) -> bool:
            return (isinstance(e, ast.Call)
                    and dotted_name(e.func).rsplit(".", 1)[-1]
                    == "inject")

        canon = self.canon(call, ctx)
        leaf = canon.rsplit(".", 1)[-1] if canon else ""
        if leaf == "write_frame" and len(call.args) >= 2:
            out.append((call.args[1], is_inject(call.args[1])))
        elif leaf == "encode_frame" and call.args:
            out.append((call.args[0], is_inject(call.args[0])))
        elif canon == "json.dumps" and call.args:
            out.append((call.args[0], False))
        for kw in call.keywords:
            if kw.arg == "header" and leaf in ("write_frame",
                                               "encode_frame"):
                out.append((kw.value, is_inject(kw.value)))
        site = _classify_call(call, ctx)
        if site is not None and self.sink_params:
            for t in self.index.resolve(site, fn):
                if t.node is None:
                    continue
                params = _param_names(t.node)
                offset = 1 if (params and params[0] in ("self", "cls")
                               and site.kind in ("self", "attr")) else 0
                for i, a in enumerate(call.args):
                    pi = i + offset
                    if (pi < len(params)
                            and (t.qualname, params[pi])
                            in self.sink_params):
                        out.append((a, is_inject(a) or
                                    (t.qualname, params[pi])
                                    in self.inject_params))
                for kw in call.keywords:
                    if kw.arg and (t.qualname, kw.arg) in self.sink_params:
                        out.append((kw.value, is_inject(kw.value) or
                                    (t.qualname, kw.arg)
                                    in self.inject_params))
        return out

    def _build_inject_params(self):
        """Function params a ``tracing.inject(param)`` call stamps the
        dtspan trace field onto (the RPC-helper idiom: the header dict
        arrives as a param, inject mutates it, write_frame sends it)."""
        for fn in self.index.functions.values():
            if fn.node is None:
                continue
            pnames = set(_param_names(fn.node))
            for call in (n for n in ast.walk(fn.node)
                         if isinstance(n, ast.Call)):
                raw = dotted_name(call.func)
                if (raw.rsplit(".", 1)[-1] == "inject"
                        and "tracing" in raw
                        and call.args
                        and isinstance(call.args[0], ast.Name)
                        and call.args[0].id in pnames):
                    self.inject_params.add((fn.qualname,
                                            call.args[0].id))

    def _build_sinks(self):
        changed = True
        while changed:
            changed = False
            for fn in self.index.functions.values():
                ctx = self.index.modules.get(fn.module)
                if ctx is None or fn.node is None:
                    continue
                pnames = set(_param_names(fn.node))
                for call in (n for n in ast.walk(fn.node)
                             if isinstance(n, ast.Call)):
                    for expr, _inj in self._sink_arg_exprs(call, fn, ctx):
                        name = _root_name(expr)
                        if (name and name in pnames
                                and (fn.qualname, name)
                                not in self.sink_params):
                            self.sink_params.add((fn.qualname, name))
                            changed = True

    def _build_frame_returners(self):
        for q, fn in self.index.functions.items():
            if fn.node is None:
                continue
            ctx = self.index.modules.get(fn.module)
            if fn.name in ("_call", "_lease_call", "_roundtrip"):
                self.frame_returners.add(q)
                continue
            frame_locals = set()
            json_locals = set()
            # pass 1: locals (ast.walk is breadth-first, so a return at
            # body level is visited before an assign nested in a try)
            for st in ast.walk(fn.node):
                if (isinstance(st, ast.Assign) and len(st.targets) == 1
                        and isinstance(st.targets[0], ast.Name)):
                    inner = _unwrap_async(st.value)
                    if isinstance(inner, ast.Call):
                        leaf = dotted_name(inner.func).rsplit(".", 1)[-1]
                        if leaf == "read_frame":
                            frame_locals.add(st.targets[0].id)
                        elif (ctx is not None
                              and self.canon(inner, ctx) == "json.loads"):
                            json_locals.add(st.targets[0].id)
            # pass 2: returns
            for st in ast.walk(fn.node):
                if isinstance(st, ast.Return) and st.value is not None:
                    inner = _unwrap_async(st.value)
                    if (isinstance(inner, ast.Call)
                            and dotted_name(inner.func).rsplit(
                                ".", 1)[-1] == "read_frame"):
                        self.frame_returners.add(q)
                    elif (isinstance(inner, ast.Name)
                          and inner.id in frame_locals):
                        self.frame_returners.add(q)
                    elif (isinstance(inner, ast.Name)
                          and inner.id in json_locals):
                        self.dict_returners.add(q)
                    elif (isinstance(inner, ast.Call) and ctx is not None
                          and self.canon(inner, ctx) == "json.loads"):
                        self.dict_returners.add(q)
                    elif (isinstance(inner, ast.Tuple)
                          and len(inner.elts) == 2
                          and isinstance(inner.elts[0], ast.Name)
                          and inner.elts[0].id in json_locals):
                        # `return header, payload` where header came from
                        # json.loads (the DTKVP1 _parse idiom)
                        self.frame_returners.add(q)

    def _build_callbacks(self):
        for fn in self.index.functions.values():
            ctx = self.index.modules.get(fn.module)
            if ctx is None or fn.node is None:
                continue
            for call in (n for n in ast.walk(fn.node)
                         if isinstance(n, ast.Call)):
                if not (isinstance(call.func, ast.Attribute)
                        and call.func.attr == "subscribe"
                        and len(call.args) >= 2):
                    continue
                subject = _normalize_subject(
                    call.args[0], fn.node, ctx, self.index, fn.cls)
                cb = call.args[1]
                target = None
                raw = dotted_name(cb)
                if raw.startswith("self.") and fn.cls:
                    ci = self.index.classes.get(fn.cls)
                    if ci:
                        target = ci.methods.get(raw.split(".", 1)[1])
                elif isinstance(cb, ast.Name):
                    target = self.index.functions.get(
                        f"{fn.module}.{cb.id}")
                if target is None or target.node is None:
                    continue
                params = _param_names(target.node)
                if params and params[0] in ("self", "cls"):
                    params = params[1:]
                if params:
                    self.callback_channels[
                        (target.qualname, params[-1])
                    ] = f"subject:{subject}"

    # ------------------------------------------------------------ the pass
    def run(self):
        self._build_inject_params()
        self._build_sinks()
        self._build_frame_returners()
        self._build_callbacks()
        for fn in self.index.functions.values():
            ctx = self.index.modules.get(fn.module)
            if ctx is None or fn.node is None:
                continue
            if isinstance(fn.node, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                self._scan_function(fn, ctx)
                self._wr006(fn, ctx)

    def _scan_function(self, fn: FunctionInfo, ctx):
        roots: list[tuple[str, str]] = []     # (local name, channel base)
        frame_vars: dict[str, str] = {}       # frame tuple var -> base
        handled_dicts: set[int] = set()       # id() of claimed Dict args
        mod_base = f"module:{fn.module}"

        # pass 1: roots produced directly by calls (ast.walk is
        # breadth-first, so a tuple-unpack at body level can be visited
        # before the nested assign that binds its frame var — collect
        # all call-bound locals before resolving unpacks in pass 2)
        for st in ast.walk(fn.node):
            if isinstance(st, ast.Assign) and len(st.targets) == 1:
                t, v = st.targets[0], st.value
                inner = _unwrap_async(v)
                if isinstance(inner, ast.Call):
                    leaf = dotted_name(inner.func).rsplit(".", 1)[-1]
                    canon = self.canon(inner, ctx)
                    base = None
                    dict_base = None
                    if leaf == "read_frame":
                        base = mod_base
                    else:
                        site = _classify_call(inner, ctx)
                        if site is not None:
                            for tgt in self.index.resolve(site, fn):
                                if tgt.qualname in self.frame_returners:
                                    base = f"module:{tgt.module}"
                                    break
                                if tgt.qualname in self.dict_returners:
                                    dict_base = f"module:{tgt.module}"
                                    break
                        if (base is None and dict_base is None and leaf in
                                ("_call", "_lease_call", "_roundtrip")):
                            base = mod_base
                    if dict_base is not None and isinstance(t, ast.Name):
                        roots.append((t.id, dict_base))
                        continue
                    if base is not None:
                        if isinstance(t, ast.Name):
                            frame_vars[t.id] = base
                        elif (isinstance(t, ast.Tuple) and t.elts
                              and isinstance(t.elts[0], ast.Name)):
                            roots.append((t.elts[0].id, base))
                        continue
                    if canon == "json.loads" and inner.args:
                        src = inner.args[0]
                        base = mod_base
                        if isinstance(src, ast.Name):
                            base = self.callback_channels.get(
                                (fn.qualname, src.id), mod_base)
                        if isinstance(t, ast.Name):
                            roots.append((t.id, base))
                        continue

        # pass 2: unpacks of pass-1 locals and awaited reply futures
        for st in ast.walk(fn.node):
            if isinstance(st, ast.Assign) and len(st.targets) == 1:
                t, v = st.targets[0], st.value
                if (isinstance(v, ast.Name) and v.id in frame_vars
                        and isinstance(t, ast.Tuple) and t.elts
                        and isinstance(t.elts[0], ast.Name)):
                    roots.append((t.elts[0].id, frame_vars[v.id]))
                    continue
                # inside an RPC round-trip helper, the awaited reply
                # future unpacks to (header, payload) — the read loop
                # resolves it with a frame on a different task
                if (fn.qualname in self.frame_returners
                        and isinstance(v, ast.Await)
                        and isinstance(_unwrap_async(v),
                                       (ast.Name, ast.Attribute))
                        and isinstance(t, ast.Tuple) and t.elts
                        and isinstance(t.elts[0], ast.Name)):
                    roots.append((t.elts[0].id, mod_base))

        # producer sites + json.loads-as-argument consumers
        for call in (n for n in ast.walk(fn.node)
                     if isinstance(n, ast.Call)):
            self._scan_call(call, fn, ctx, handled_dicts)

        for name, base in roots:
            profile = _Profile()
            _ReadWalker(self, fn, ctx, name, profile).run(fn.node.body)
            if not profile.empty:
                self.consumers.append(_Consumer(fn.module, base,
                                                profile))

        # consumer: a subscribe-callback whose payload is parsed by a
        # decode helper (the json.loads lives in the callee) — profile
        # the param itself; callbacks that json.loads inline are
        # already rooted above, so skip them to avoid double counting
        for p in _param_names(fn.node):
            base = self.callback_channels.get((fn.qualname, p))
            if base is None:
                continue
            if any(isinstance(n, ast.Call)
                   and self.canon(n, ctx) == "json.loads"
                   and n.args and isinstance(n.args[0], ast.Name)
                   and n.args[0].id == p
                   for n in ast.walk(fn.node)):
                continue
            profile = self.param_profile(fn, p)
            if not profile.empty:
                self.consumers.append(_Consumer(fn.module, base,
                                                profile))

    def _scan_call(self, call: ast.Call, fn: FunctionInfo, ctx,
                   handled: set):
        canon = self.canon(call, ctx)
        leaf = (canon.rsplit(".", 1)[-1] if canon
                else (call.func.attr
                      if isinstance(call.func, ast.Attribute) else ""))
        mod_base = f"module:{fn.module}"

        # consumer: json.loads(...) passed straight into a callee
        for i, a in enumerate(call.args):
            if not (isinstance(a, ast.Call)
                    and self.canon(a, ctx) == "json.loads" and a.args):
                continue
            base = mod_base
            if isinstance(a.args[0], ast.Name):
                base = self.callback_channels.get(
                    (fn.qualname, a.args[0].id), mod_base)
            site = _classify_call(call, ctx)
            if site is None:
                continue
            for t in self.index.resolve(site, fn):
                if t.node is None:
                    continue
                params = _param_names(t.node)
                offset = 1 if (params and params[0] in ("self", "cls")
                               and site.kind in ("self", "attr")) else 0
                pi = i + offset
                if pi < len(params):
                    sub = self.param_profile(t, params[pi], depth=1)
                    if not sub.empty:
                        self.consumers.append(
                            _Consumer(fn.module, base, sub))
                break
        # consumer: Cls(**json.loads(payload)) — opaque destructuring
        for kw in call.keywords:
            if kw.arg is None and isinstance(kw.value, ast.Call) \
                    and self.canon(kw.value, ctx) == "json.loads" \
                    and kw.value.args:
                base = mod_base
                if isinstance(kw.value.args[0], ast.Name):
                    base = self.callback_channels.get(
                        (fn.qualname, kw.value.args[0].id), mod_base)
                p = _Profile(opaque=True)
                self.consumers.append(_Consumer(fn.module, base, p))

        # producers via header sinks
        sunk = self._sink_arg_exprs(call, fn, ctx)
        for expr, injected in sunk:
            src = self._as_dict_source(expr, fn, ctx)
            if src not in (None, "opaque"):
                handled.add(id(src[0]))
            if canon == "json.dumps":
                self._wr005(expr, src, fn, ctx)
            self.add_producer(src, mod_base, False, fn.module,
                              injected=injected)

        # producers via pub/sub publish
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr == "publish" and len(call.args) >= 2):
            subject = _normalize_subject(call.args[0], fn.node, ctx,
                                         self.index, fn.cls)
            src = self._as_dict_source(call.args[1], fn, ctx)
            if src not in (None, "opaque"):
                handled.add(id(src[0]))
            self.add_producer(src, f"subject:{subject}", False,
                              fn.module)

        # durable producers: WAL/file writes and coordinator kv puts
        if leaf in ("write", "write_text") and call.args:
            inner = self._find_json_dumps(call.args[0], ctx)
            if inner is not None:
                src = self._as_dict_source(inner, fn, ctx)
                if src not in (None, "opaque"):
                    handled.add(id(src[0]))
                self.add_producer(src, mod_base, True, fn.module)
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in ("kv_put", "kv_create",
                                       "kv_create_or_validate")
                and len(call.args) >= 2):
            inner = self._find_json_dumps(call.args[1], ctx)
            if inner is not None:
                keyfrag = _normalize_subject(call.args[0], fn.node, ctx,
                                             self.index, fn.cls)
                src = self._as_dict_source(inner, fn, ctx)
                if src not in (None, "opaque"):
                    handled.add(id(src[0]))
                self.add_producer(src, f"kv:{keyfrag}", True, fn.module)

        # fallback: a dict literal with a discriminator key passed to
        # any call we could not resolve (e.g. a nested send() closure)
        if not sunk and leaf not in ("publish",):
            for a in call.args:
                if (isinstance(a, ast.Dict) and id(a) not in handled
                        and any(isinstance(k, ast.Constant)
                                and k.value in DISC_KEYS
                                for k in a.keys if k is not None)):
                    handled.add(id(a))
                    self.add_producer(
                        (a, None, fn.node, ctx, fn.module),
                        mod_base, False, fn.module)

    def _find_json_dumps(self, expr, ctx) -> Optional[ast.Call]:
        for n in ast.walk(expr):
            if (isinstance(n, ast.Call)
                    and self.canon(n, ctx) == "json.dumps" and n.args):
                return n
        return None

    # ----------------------------------------------------------- WR005
    def _wr005(self, expr, src, fn: FunctionInfo, ctx):
        if src in (None, "opaque"):
            return
        d, varname, owner_node, owner_ctx, owner_mod = src[:5]
        checks: list[tuple[str, ast.AST]] = []
        for k, v in zip(d.keys, d.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                checks.append((k.value, v))
        if varname:
            for st in ast.walk(owner_node):
                if isinstance(st, ast.Assign):
                    for t in st.targets:
                        if (isinstance(t, ast.Subscript)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == varname
                                and isinstance(t.slice, ast.Constant)
                                and isinstance(t.slice.value, str)):
                            checks.append((t.slice.value, st.value))
        for aug_node, aug_var, _aug_ctx, _aug_mod in src[5:]:
            for st in ast.walk(aug_node):
                if isinstance(st, ast.Assign):
                    for t in st.targets:
                        if (isinstance(t, ast.Subscript)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == aug_var
                                and isinstance(t.slice, ast.Constant)
                                and isinstance(t.slice.value, str)):
                            checks.append((t.slice.value, st.value))
        for key, value in checks:
            why = self._json_unsafe(value, owner_node, owner_ctx)
            if why:
                self.site_findings.append(WireFinding(
                    f"module:{owner_mod}", "WR005",
                    f"{fn.name}:{key}",
                    f"value for key '{key}' is {why} — json.dumps "
                    f"will raise or mangle it"))

    def _json_unsafe(self, expr, fn_node, ctx, hop=0) -> Optional[str]:
        if isinstance(expr, ast.Constant) and isinstance(
                expr.value, (bytes, bytearray)):
            return "a bytes literal"
        if isinstance(expr, ast.Call):
            raw = dotted_name(expr.func)
            canon = ctx.canonical(raw) if raw else ""
            head = canon.split(".", 1)[0]
            if head in ("numpy", "torch"):
                return f"a {canon}() value (numpy/torch scalar or tensor)"
            if canon == "struct.pack":
                return "struct.pack() bytes"
            if isinstance(expr.func, ast.Attribute) and \
                    expr.func.attr in ("tobytes", "encode"):
                return f"a .{expr.func.attr}() bytes value"
        if isinstance(expr, ast.Name) and hop == 0:
            a = self._local_assign(fn_node, expr.id)
            if a is not None:
                return self._json_unsafe(a, fn_node, ctx, hop=1)
        return None

    # ----------------------------------------------------------- WR006
    def _wr006(self, fn: FunctionInfo, ctx):
        found: set[str] = set()

        def closed_target(call) -> Optional[str]:
            canon = self.canon(call, ctx)
            leaf = canon.rsplit(".", 1)[-1] if canon else ""
            if leaf == "close_writer" and call.args:
                t = dotted_name(call.args[0])
                return t or None
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr in ("close", "abort"):
                t = dotted_name(call.func.value)
                if t.endswith(".transport"):
                    t = t[: -len(".transport")]
                return t or None
            return None

        def scan(body, closed: set) -> Optional[set]:
            for st in body:
                if isinstance(st, (ast.Return, ast.Raise, ast.Break,
                                   ast.Continue)):
                    return None
                if isinstance(st, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                    continue        # closure body runs later
                if isinstance(st, ast.If):
                    b = scan(list(st.body), set(closed))
                    o = scan(list(st.orelse), set(closed))
                    if b is None and o is None:
                        return None
                    closed = (b if o is None else
                              o if b is None else (b & o))
                    continue
                if isinstance(st, ast.Try):
                    outs = [scan(list(st.body), set(closed))]
                    for h in st.handlers:
                        outs.append(scan(list(h.body), set(closed)))
                    live = [x for x in outs if x is not None]
                    closed = (set.intersection(*live) if live
                              else set(closed))
                    f = scan(list(st.finalbody), closed)
                    if f is None:
                        return None
                    closed = f
                    continue
                if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                    scan(list(st.body), set(closed))
                    continue
                if isinstance(st, (ast.With, ast.AsyncWith)):
                    r = scan(list(st.body), closed)
                    if r is None:
                        return None
                    closed = r
                    continue
                if isinstance(st, ast.Assign):
                    for t in st.targets:
                        name = dotted_name(t)
                        if name:
                            closed = {c for c in closed
                                      if c != name
                                      and not c.startswith(name + ".")}
                for node in ast.walk(st):
                    if not isinstance(node, ast.Call):
                        continue
                    canon = self.canon(node, ctx)
                    leaf = canon.rsplit(".", 1)[-1] if canon else ""
                    if leaf == "write_frame" and node.args:
                        target = dotted_name(node.args[0])
                        if target and target in closed:
                            found.add(target)
                    t = closed_target(node)
                    if t:
                        closed.add(t)
            return closed

        scan(list(fn.node.body), set())
        for writer in sorted(found):
            self.site_findings.append(WireFinding(
                f"module:{fn.module}", "WR006",
                f"{fn.name}:{writer}",
                f"write_frame({writer}, ...) reachable after "
                f"{writer} was closed/aborted on the same path"))


# --------------------------------------------------------------- channels ----


@dataclass
class _Channel:
    name: str
    disc: Optional[str]
    durable: bool = False
    # variant -> {"keys": merged {k: mode}, "opaque": bool, "sites": n}
    variants: dict = field(default_factory=dict)
    # variant -> {key: "required" | "optional"}
    reads: dict = field(default_factory=dict)
    produced_domain: set = field(default_factory=set)
    consumed_domain: set = field(default_factory=set)
    n_producers: int = 0
    n_consumers: int = 0
    opaque_consumers: bool = False
    open_dispatch: bool = False
    unknown_disc: bool = False     # some producer's disc value unresolved


def _producer_disc(p: _Producer) -> Optional[str]:
    for k in DISC_KEYS:
        if k in p.keys:
            return k
    return None


def _assemble(ext: _Extractor) -> dict[str, _Channel]:
    channels: dict[str, _Channel] = {}
    sites: dict[str, list[tuple[str, _Producer]]] = {}

    def chan(base: str, disc: Optional[str]) -> _Channel:
        name = f"{base}/{disc or '-'}"
        ch = channels.get(name)
        if ch is None:
            ch = channels[name] = _Channel(name, disc)
        return ch

    for p in ext.producers:
        disc = _producer_disc(p)
        ch = chan(p.base, disc)
        ch.n_producers += 1
        ch.durable = ch.durable or p.durable
        values = ["-"]
        if disc:
            values = sorted(p.domains.get(disc, {"?"}))
            if "?" in values:
                ch.unknown_disc = True
        ch.produced_domain.update(v for v in values
                                  if v not in ("-", "?"))
        for v in values:
            sites.setdefault(ch.name, []).append((v, p))

    for name, vlist in sites.items():
        ch = channels[name]
        by_variant: dict[str, list[_Producer]] = {}
        for v, p in vlist:
            by_variant.setdefault(v, []).append(p)
        for v, plist in by_variant.items():
            all_keys: set[str] = set()
            for p in plist:
                all_keys |= set(p.keys)
            merged = {}
            for k in all_keys:
                merged[k] = ("always" if all(
                    p.keys.get(k) == "always" for p in plist)
                    else "maybe")
            ch.variants[v] = {
                "keys": merged,
                "opaque": any(p.opaque for p in plist),
                "sites": len(plist),
            }

    for c in ext.consumers:
        pr = c.profile
        ch = chan(c.base, pr.disc)
        ch.n_consumers += 1
        ch.consumed_domain |= pr.domain
        ch.opaque_consumers = ch.opaque_consumers or pr.opaque
        ch.open_dispatch = ch.open_dispatch or pr.open_dispatch
        spill = None
        if pr.disc and any("~else" in tags for _, _, tags in pr.reads):
            # the dispatch's terminal else handles messages that carry
            # no discriminator (a reply routed past the push arms) —
            # those reads also consume the base's disc-less channel
            spill = chan(c.base, None)
            spill.n_consumers += 1
            spill.opaque_consumers = (spill.opaque_consumers
                                      or pr.opaque)
        for key, required, tags in pr.reads:
            variants = sorted(tags) if tags else ["*"]
            for v in variants:
                if v == "?":
                    continue
                rmap = ch.reads.setdefault(v, {})
                sev = "required" if required else "optional"
                if rmap.get(key) != "required":
                    rmap[key] = sev
                if v == "~else" and spill is not None:
                    smap = spill.reads.setdefault("*", {})
                    if smap.get(key) != "required":
                        smap[key] = sev

    # keep a channel only when both halves were extracted, or when the
    # payload is durable (a file/KV write has an implicit future reader)
    return {
        name: ch for name, ch in channels.items()
        if (ch.n_producers and ch.n_consumers)
        or (ch.durable and ch.n_producers)
    }


# ------------------------------------------------------------ channel rules ----


def _check_channels(channels: dict[str, _Channel]) -> list[WireFinding]:
    findings: list[WireFinding] = []
    for name in sorted(channels):
        ch = channels[name]
        star_reads = dict(ch.reads.get("*", {}))
        star_reads.update(ch.reads.get("~else", {}))

        # WR001 — dead wire field
        if ch.n_consumers and not ch.opaque_consumers:
            for v in sorted(ch.variants):
                if v == "?":
                    continue
                if (ch.disc and ch.consumed_domain
                        and v != "-" and v not in ch.consumed_domain):
                    continue    # whole variant unhandled -> WR003's job
                readable = set(star_reads) | set(ch.reads.get(v, {}))
                for k in sorted(ch.variants[v]["keys"]):
                    if k == ch.disc or k in readable:
                        continue
                    if k in VERSION_KEYS:
                        # version tags exist for readers that don't
                        # exist yet — unread-by-design (WR004's point)
                        continue
                    findings.append(WireFinding(
                        name, "WR001", f"{v}:{k}",
                        f"field '{k}' (variant '{v}') is written by "
                        f"producers but read by no extracted consumer"))

        # WR002 — latent KeyError
        if ch.n_producers:
            for v in sorted(ch.reads):
                if v == "~else":
                    continue
                if v == "*":
                    targets = [t for t in ch.variants if t != "?"]
                else:
                    targets = [v] if v in ch.variants else []
                for k, sev in sorted(ch.reads[v].items()):
                    if sev != "required" or k == ch.disc:
                        continue
                    for tv in targets:
                        var = ch.variants[tv]
                        if var["opaque"]:
                            continue
                        if var["keys"].get(k) != "always":
                            findings.append(WireFinding(
                                name, "WR002", f"{v}:{k}",
                                f"consumer reads '{k}' with no default "
                                f"but producer variant '{tv}' does not "
                                f"always write it"))
                            break

        # WR003 — discriminator drift
        if ch.disc and ch.produced_domain and ch.consumed_domain:
            if not ch.open_dispatch:
                for val in sorted(ch.produced_domain
                                  - ch.consumed_domain):
                    findings.append(WireFinding(
                        name, "WR003", f"produced-unhandled:{val}",
                        f"producers emit {ch.disc}='{val}' but no "
                        f"consumer dispatch handles it"))
            if not ch.unknown_disc:
                for val in sorted(ch.consumed_domain
                                  - ch.produced_domain):
                    findings.append(WireFinding(
                        name, "WR003", f"consumed-unproduced:{val}",
                        f"a consumer dispatches on {ch.disc}='{val}' "
                        f"but no producer emits it"))

        # WR004 — unversioned durable payload
        if ch.durable and ch.n_producers:
            opaque_only = all(v["opaque"] and not v["keys"]
                              for v in ch.variants.values())
            tagged = any(set(v["keys"]) & VERSION_KEYS
                         for v in ch.variants.values())
            if not tagged and not opaque_only:
                findings.append(WireFinding(
                    name, "WR004", "unversioned",
                    "persisted payload carries no version/generation "
                    "tag (DTKVP1-style) — old readers cannot detect a "
                    "format change"))
    return findings


# ------------------------------------------------------------------- facts ----


def _channel_facts(ch: _Channel) -> dict:
    variants = {}
    for v in sorted(ch.variants):
        var = ch.variants[v]
        reads = dict(ch.reads.get("*", {}))
        reads.update(ch.reads.get("~else", {}))
        reads.update(ch.reads.get(v, {}))
        variants[v] = {
            "produced": {k: var["keys"][k] for k in sorted(var["keys"])},
            "required": sorted(k for k, s in reads.items()
                               if s == "required"),
            "optional": sorted(k for k, s in reads.items()
                               if s == "optional"),
        }
    schema_src = {
        "discriminator": ch.disc,
        "durable": ch.durable,
        "version_tagged": any(set(v["keys"]) & VERSION_KEYS
                              for v in ch.variants.values()),
        "produced_domain": sorted(ch.produced_domain),
        "consumed_domain": sorted(ch.consumed_domain),
        "variants": variants,
    }
    schema = hashlib.sha256(
        json.dumps(schema_src, sort_keys=True).encode()
    ).hexdigest()[:16]
    facts = dict(schema_src)
    facts.update({
        "schema": schema,
        "producers": ch.n_producers,
        "consumers": ch.n_consumers,
    })
    return facts


def collect_wire_facts(paths: Optional[Sequence] = None,
                       root: Optional[Path] = None):
    """(channel facts dict, intrinsic WR001–WR006 findings) over the
    wire-plane scope (or explicit ``paths``, e.g. fixtures)."""
    if root is None:
        root = Path(__file__).resolve().parents[2]
    if paths:
        files = list(iter_python_files([Path(p) for p in paths]))
    else:
        pkg = Path(__file__).resolve().parents[1]
        scope = [pkg / d for d in WIRE_SCOPE_DIRS]
        files = list(iter_python_files([d for d in scope
                                        if d.exists()]))
    index = ProjectIndex.build(files, root=root)
    ext = _Extractor(index)
    ext.run()
    channels = _assemble(ext)
    facts = {name: _channel_facts(ch)
             for name, ch in sorted(channels.items())}
    intrinsic = sorted(_check_channels(channels) + ext.site_findings)
    return facts, intrinsic


def check_wire(facts: dict, manifest: WireManifest,
               intrinsic: Sequence[WireFinding] = ()) -> list[WireFinding]:
    """Intrinsic findings + WR007 drift vs the committed manifest."""
    findings = list(intrinsic)
    if manifest.messages:
        cur, prev = set(facts), set(manifest.messages)
        for name in sorted(cur - prev):
            findings.append(WireFinding(
                name, "WR007", "added",
                "new wire message type not in the committed manifest "
                "(run lint --wire --update-baseline to review the diff)"))
        for name in sorted(prev - cur):
            findings.append(WireFinding(
                name, "WR007", "removed",
                "wire message type in the manifest is no longer "
                "extracted from the code"))
        for name in sorted(cur & prev):
            old = manifest.messages[name].get("schema")
            new = facts[name].get("schema")
            if old != new:
                findings.append(WireFinding(
                    name, "WR007", "schema-drift",
                    f"extracted schema {new} != committed {old} — "
                    f"wire contract changed"))
    return sorted(findings)


# --------------------------------------------------------------------- CLI ----


def run_wire(args, out) -> int:
    """``python -m dynamo_tpu_torch lint --wire``: text or stable JSON, exit 1 on any
    non-accepted finding, `--update-baseline` re-snapshots the wire
    manifest (carrying justifications by key)."""
    manifest_path = Path(
        getattr(args, "manifest", None) or DEFAULT_WIRE_MANIFEST_PATH
    )
    manifest = WireManifest.load(manifest_path)
    paths = getattr(args, "paths", None) or None
    root = getattr(args, "root", None)
    facts, intrinsic = collect_wire_facts(
        paths, root=Path(root) if root else None)
    findings = check_wire(facts, manifest, intrinsic)

    if getattr(args, "update_baseline", False):
        # WR007 drift is resolved by the snapshot itself; intrinsic
        # findings become accepted entries
        keep = [f for f in findings if f.rule != "WR007"]
        WireManifest.from_facts(facts, keep, manifest).save(
            manifest_path)
        print(
            f"wire manifest updated: {len(facts)} message type"
            f"{'' if len(facts) == 1 else 's'}, {len(keep)} accepted "
            f"finding{'' if len(keep) == 1 else 's'} -> "
            f"{manifest_path}",
            file=out,
        )
        return 0

    fresh = manifest.filter(findings)
    n_accepted = len(findings) - len(fresh)
    if getattr(args, "fmt", "text") == "json":
        doc = {
            "findings": [f.to_json() for f in fresh],
            "accepted": n_accepted,
            "total": len(findings),
            "messages": sorted(facts),
        }
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        for f in fresh:
            print(f.render(), file=out)
        print(
            f"{len(fresh)} wire finding{'s' if len(fresh) != 1 else ''} "
            f"({n_accepted} accepted) over {len(facts)} message types",
            file=out,
        )
    return 1 if fresh else 0
