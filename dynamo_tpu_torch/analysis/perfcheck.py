"""Perf-plane static analysis (dtperf): the H100 roofline of every step function.

The counterpart of ``dynamo_tpu/analysis/perfcheck.py``, with its rules,
tolerances, manifest contract and ``/metrics`` rows, read for the card.  The
JAX plane walks jaxprs; this one runs each registered serving entry point
once on ``torch.device("meta")`` (shapes, no data, no memory: Llama-3-8B's
16 GB of weights cost nothing) under a ``TorchDispatchMode`` that prices
every aten op by the JAX plane's rules:

- ``mm`` / ``addmm`` / ``bmm`` (what ``linear``, ``matmul`` and ``einsum``
  become), ``_int_mm`` and ``_grouped_mm``: 2·out·K FLOPs by the input's dtype (int8
  at 1,979 TFLOP/s, bf16 at 989, f32 at 67: ``obs/topology.py``), bytes =
  operands + output;
- gather and index ops: the bytes they touch (output + indices); scatters
  and index-puts: their updates (and indices) read and written;
- reductions, ``softmax``, ``sort`` and ``topk``: one FLOP an input
  element, bytes in + out;
- elementwise: one FLOP an output element (transcendentals ×8) and its
  output bytes only: JAX's fusion assumption, so the prediction is a bound
  on the work, not a count of eager PyTorch's traffic;
- views and reshapes are free; copies, concatenations and dtype converts
  move their bytes in and out.

The walk follows the card's route: for its duration a meta tensor answers
``is_cuda`` as True, so the serving ops dispatch to the kernel wrappers,
which the walk replaces (the way the sanitizer patches its seams; nothing in
a wrapper knows).  A wrapper call becomes a ``kernels`` row priced from the
registry's ``work_cost`` at the most work its operands' shapes allow
(``registry.static_geometry``: every row at its full table, as the JAX
plane's ``pallas_kernel`` row), and returns an empty output of the right
shape.  A plain version that reads nothing on the host (decode, prefill,
the W8A16 product) is walked beside it as ``plain`` and left out of the
step; the ragged and grouped ones read their row tables on the host and are
never run on shapes.  The mesh collectives of ``ops/ring_attention.py`` go
through a recording stand-in mesh into a census (op × axis × payload ×
count), priced by ``obs/topology.collective_cost_s`` on NVLink.

Per (entry point, config) signature the facts are FLOPs by dtype, bytes,
intensity, the kernel rows, the collective census and the roofline
``max(Σ FLOPs_dt / peak_dt, bytes / HBM rate) + Σ collectives``.  They
commit to ``analysis/perf_manifest.json`` under the metrics plane's
manifest contract, its header pinning ``obs.topology.CONSTANTS_VERSION``.

Rules: PF001 predicted-latency-regression (5%; also on a constants-version
mismatch and for added / removed entry points), PF002 unexpected-collective
(intrinsic, count-keyed), PF003 arithmetic-intensity-drop on a
compute-bound entry (10%), PF004 bytes-regression on a bandwidth-bound one
(5%).  :func:`manifest_predictions` reads only the JSON: it is what
``/metrics`` renders as ``dynamo_tpu_perf_predicted_step_ms``.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from dynamo_tpu_torch.analysis.metcheck import MetricFinding as PerfFinding
from dynamo_tpu_torch.analysis.metcheck import MetricsManifest as PerfManifest
from dynamo_tpu_torch.obs import topology

__all__ = [
    "Call",
    "DEFAULT_PERF_MANIFEST_PATH",
    "Dispatch",
    "PERF_RULES",
    "PerfEntry",
    "PerfFinding",
    "PerfManifest",
    "build_perf_registry",
    "check_perf_facts",
    "collect_perf_facts",
    "estimate_callable",
    "manifest_predictions",
    "run_perf",
    "walk",
]

DEFAULT_PERF_MANIFEST_PATH = Path(__file__).parent / "perf_manifest.json"

PERF_RULES = {
    "PF001": ("predicted-latency-regression",
              "roofline-predicted step latency regressed beyond the tolerance band vs the "
              "committed perf manifest"),
    "PF002": ("unexpected-collective",
              "collective census entry (op x axis x count) without a justified acceptance"),
    "PF003": ("arithmetic-intensity-drop",
              "compute-bound entry point lost arithmetic intensity (bytes grew faster than FLOPs)"),
    "PF004": ("bytes-regression",
              "bandwidth-bound entry point's modeled HBM traffic grew beyond the tolerance band"),
}

LATENCY_REL_TOL = 0.05    # PF001
INTENSITY_REL_TOL = 0.10  # PF003
BYTES_REL_TOL = 0.05      # PF004

TRANSCENDENTAL_WEIGHT = 8

# the link a collective of the walk is priced on (one H100 host)
COLLECTIVE_LINK = "nvlink"

_MANIFEST_NOTE = (
    "CPU-derived roofline facts of the port's step functions on the H100: each "
    "entry point runs once on torch.device('meta') under a TorchDispatchMode "
    "that prices every aten op by the JAX perf plane's rules.  Elementwise ops "
    "are charged their output bytes only (the fusion assumption), so a "
    "prediction is a bound on the work, not a count of eager PyTorch's traffic "
    "(which re-reads every elementwise input).  The walk takes the card's "
    "route: kernel wrapper calls are priced from ops/kernels/registry.py's "
    "work_cost at the most work their shapes allow (every row at its full "
    "table) as `kernels` rows; a plain version that reads nothing on the host "
    "is walked beside it as `plain` and left out of the step.  Collectives go "
    "through a recording mesh and are priced on NVLink.  The model ranks and "
    "gates relative changes; its absolute calibration is the "
    "predicted-vs-measured dispatch gauge on /metrics and chip_smoke.py's "
    "`perf` line (predicted vs profiled device ms of the same forwards)."
)


# ---------------------------------------------------------------- costs ----


class Costs:
    """One walk's accumulator: FLOPs by dtype, HBM bytes, the FLOPs of
    plain (unbatched) matrix products, kernel rows, plain rows and the
    collective census."""

    def __init__(self) -> None:
        self.flops_by_dtype: dict[str, float] = {}
        self.bytes = 0.0
        self.matmul_flops = 0.0
        self.kernels: dict[str, dict] = {}
        self.plain: dict[str, Optional[dict]] = {}
        self.collectives: dict[str, dict] = {}

    @property
    def flops(self) -> float:
        return sum(self.flops_by_dtype.values())

    def add_flops(self, dtype: str, n: float) -> None:
        if n:
            self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + n

    def add_collective(self, op: str, axis: str, axis_size: int, payload: float) -> None:
        e = self.collectives.setdefault(f"{op}:{axis}", {
            "count": 0, "payload_bytes": 0.0, "axis_size": axis_size, "cost_s": 0.0})
        e["count"] += 1
        e["payload_bytes"] += payload
        e["cost_s"] += topology.collective_cost_s(op, axis_size, int(payload), link=COLLECTIVE_LINK)


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _nbytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _tensors(x) -> list:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "unsqueeze", "squeeze", "expand",
    "expand_as", "permute", "transpose", "t", "select", "slice", "alias", "detach", "as_strided",
    "split", "split_with_sizes", "unbind", "chunk", "narrow", "diagonal", "view_as", "unflatten",
    "flatten", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "device", "sym_size", "sym_stride",
    "is_same_size", "_to_dense", "unsafe_split", "movedim", "numpy_T", "real", "view_as_real",
    "resolve_conj", "resolve_neg", "result_type", "size", "stride", "dim", "_has_compatible_shallow_copy_type",
}
_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "_grouped_mm", "_int_mm"}
_GATHER = {"index", "gather", "index_select", "embedding", "take", "take_along_dim"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_", "scatter_add",
            "scatter_add_", "scatter_reduce", "scatter_reduce_", "index_add", "index_add_",
            "index_copy", "index_copy_", "masked_scatter", "masked_scatter_", "copy_"}
_MOVE = {"cat", "stack", "constant_pad_nd", "pad", "flip", "roll", "repeat", "clone", "_to_copy",
         "contiguous", "tril", "triu", "repeat_interleave", "_unsafe_index"}
_REDUCE = {"sum", "mean", "amax", "amin", "argmax", "argmin", "prod", "var", "var_mean", "std",
           "std_mean", "norm", "linalg_vector_norm", "logsumexp", "cumsum", "cumprod", "any", "all",
           "_softmax", "_log_softmax", "softmax", "log_softmax", "sort", "topk", "kthvalue",
           "median", "argsort", "max", "min", "bincount", "multinomial"}
_FACTORY = {"zeros", "ones", "full", "arange", "scalar_tensor", "zeros_like", "ones_like",
            "full_like", "new_zeros", "new_ones", "new_full", "fill", "fill_", "zero_", "linspace",
            "eye", "tensor"}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid",
                   "erf", "erfinv", "erfc", "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
                   "sinh", "cosh", "pow", "rsqrt", "sqrt", "silu", "gelu", "softplus", "logit",
                   "exponential", "exponential_"}


def _matmul_flops(name: str, args) -> tuple[str, float, bool]:
    """(input dtype, 2·out·K, whether batched) of a matrix product."""
    if name == "addmm":
        a, b = args[1], args[2]
    elif name == "baddbmm":
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    k = a.shape[-1]
    if name in ("bmm", "baddbmm"):
        out = a.shape[0] * a.shape[1] * b.shape[-1]
    elif name == "_grouped_mm":
        out = a.shape[0] * b.shape[-1]
    else:
        out = a.shape[0] * b.shape[1]
    return _dt(a.dtype), 2.0 * out * k, name in ("bmm", "baddbmm", "_grouped_mm")


def price_op(acc: Costs, func, args, kwargs, out) -> None:
    """Price one aten op into ``acc`` by the JAX plane's rules."""
    name = func.overloadpacket.__name__
    if name in _FREE:
        return
    ins = _tensors(args) + _tensors(list((kwargs or {}).values()))
    outs = _tensors(out)
    if name in _MATMUL:
        dt, f, batched = _matmul_flops(name, args)
        acc.add_flops(dt, f)
        if not batched:
            acc.matmul_flops += f
        acc.bytes += _nbytes(ins) + _nbytes(outs)
    elif name in _GATHER:
        idx = [t for t in ins[1:] if not t.is_floating_point()]
        acc.bytes += _nbytes(outs) + _nbytes(idx)
    elif name in _SCATTER:
        upd = ins[1:]  # indices and values: the operand passes through in place
        acc.bytes += 2.0 * _nbytes(upd)
        if "add" in name or "reduce" in name:
            acc.add_flops(_dt(upd[-1].dtype), float(upd[-1].numel()))
    elif name in _MOVE:
        acc.bytes += _nbytes(ins[:1] if name != "cat" and name != "stack" else ins) + _nbytes(outs)
    elif name in _REDUCE and not (name in ("max", "min") and len(ins) > 1):
        if ins:
            acc.add_flops(_dt(ins[0].dtype), float(ins[0].numel()))
        acc.bytes += _nbytes(ins[:1]) + _nbytes(outs)
    elif name in _FACTORY:
        acc.bytes += _nbytes(outs)
    elif outs:
        w = TRANSCENDENTAL_WEIGHT if name in _TRANSCENDENTAL else 1
        acc.add_flops(_dt(outs[0].dtype), float(outs[0].numel()) * w)
        acc.bytes += _nbytes(outs[:1])


# ----------------------------------------------------------------- walk ----


def _meta_is_cuda(t) -> bool:
    return t.device.type in ("cuda", "meta")


@contextlib.contextmanager
def card_route():
    """For the walk's duration a meta tensor answers ``is_cuda`` as True,
    so the serving ops take the route they take on the card."""
    import torch

    had = "is_cuda" in torch.Tensor.__dict__
    old = torch.Tensor.__dict__.get("is_cuda")
    torch.Tensor.is_cuda = property(_meta_is_cuda)
    try:
        yield
    finally:
        if had:
            torch.Tensor.is_cuda = old
        else:
            del torch.Tensor.is_cuda


class _Pricer:
    """The walk's dispatch mode, with a stack of accumulators (a kernel
    call's plain version prices into its own).  ``observers`` see every op
    (``op(func, args, kwargs, out, depth)``) and every kernel call
    (``kernel(name, operands, depth)``); depth 1 is the card's route, a
    deeper one a plain version walked beside its kernel."""

    def __init__(self, observers=(), plain: bool = True):
        from torch.utils._python_dispatch import TorchDispatchMode

        pricer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                price_op(pricer.stack[-1], func, args, kwargs, out)
                for o in pricer.observers:
                    o.op(func, args, kwargs, out, len(pricer.stack))
                return out

        self.stack = [Costs()]
        self.observers = tuple(observers)
        self.plain = plain
        self.mode = Mode()


def _kernel_out(kernel: str, a: dict):
    import torch

    if kernel == "int8_matmul":
        x = a["x"]
        return torch.empty((x.shape[0], a["wq"].shape[1]), dtype=a.get("out_dtype") or x.dtype,
                           device=x.device)
    if kernel.startswith("grouped"):
        x, w = a["x"], a.get("w", a.get("wq"))
        return torch.empty((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
    return torch.empty_like(a["q"])


def _stand_in(kernel: str, wrapper, pricer: _Pricer):
    """What a kernel wrapper becomes for the walk: a ``kernels`` row from
    the registry's work cost at the operands' static geometry, the plain
    version walked beside it when it reads nothing on the host, an empty
    output of the kernel's shape."""
    from dynamo_tpu_torch.ops.kernels import registry

    sig = inspect.signature(wrapper)
    meta = registry.KERNELS[kernel]

    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        a = dict(bound.arguments)
        cost = registry.work_cost(kernel, registry.static_geometry(kernel, a))
        acc = pricer.stack[-1]
        row = acc.kernels.setdefault(kernel, {"calls": 0, "flops": 0, "hbm_bytes": 0,
                                              "transcendentals": 0})
        row["calls"] += 1
        for key in ("flops", "hbm_bytes", "transcendentals"):
            row[key] += cost[key]
        acc.add_flops("bfloat16", cost["flops"])
        acc.bytes += cost["hbm_bytes"]
        for o in pricer.observers:
            o.kernel(kernel, a, len(pricer.stack))
        if meta["plain_reads_host"] or not pricer.plain:
            acc.plain[kernel] = None
        else:
            side = Costs()
            pricer.stack.append(side)
            try:
                registry.plain_fn(kernel)(*args, **kwargs)
            finally:
                pricer.stack.pop()
            prow = acc.plain.get(kernel) or {"calls": 0, "flops": 0, "bytes": 0}
            prow["calls"] += 1
            prow["flops"] += int(side.flops)
            prow["bytes"] += int(side.bytes)
            acc.plain[kernel] = prow
        return _kernel_out(kernel, a)

    return call


@contextlib.contextmanager
def _kernels_stood_in(pricer: _Pricer):
    """Every module attribute of the port that holds a kernel wrapper
    holds its stand-in for the walk's duration."""
    from dynamo_tpu_torch.ops.kernels import registry

    wrappers = {id(registry.wrapper_fn(k)): k for k, m in registry.KERNELS.items()
                if not m["placeholder"]}
    stand = {k: _stand_in(k, registry.wrapper_fn(k), pricer) for k in wrappers.values()}
    pkg = __name__.split(".")[0]
    patched = []
    for mname, mod in list(sys.modules.items()):
        if mod is None or not (mname == pkg or mname.startswith(pkg + ".")):
            continue
        for attr, val in list(vars(mod).items()):
            kernel = wrappers.get(id(val))
            if kernel is not None and callable(val):
                patched.append((mod, attr, val))
                setattr(mod, attr, stand[kernel])
    try:
        yield
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


def _roofline(acc: Costs) -> dict:
    topo = topology.TOPOLOGIES[topology.DEFAULT_TOPOLOGY]
    compute_s = sum(n / topo["peak_flops"].get(dt, topo["default_flops"])
                    for dt, n in acc.flops_by_dtype.items())
    memory_s = acc.bytes / topo["hbm_bw"]
    collective_s = sum(e["cost_s"] for e in acc.collectives.values())
    return {
        "compute_ms": round(compute_s * 1e3, 6),
        "memory_ms": round(memory_s * 1e3, 6),
        "collective_ms": round(collective_s * 1e3, 6),
        "total_ms": round((max(compute_s, memory_s) + collective_s) * 1e3, 6),
        "bound": "compute" if compute_s >= memory_s else "bandwidth",
    }


def _facts(acc: Costs) -> dict:
    flops, nbytes = int(acc.flops), int(acc.bytes)
    return {
        "flops": flops,
        "flops_by_dtype": {dt: int(n) for dt, n in sorted(acc.flops_by_dtype.items())},
        "matmul_flops": int(acc.matmul_flops),
        "bytes": nbytes,
        "intensity": round(flops / nbytes, 4) if nbytes else 0.0,
        "kernels": {k: dict(v) for k, v in sorted(acc.kernels.items())},
        "plain": {k: v for k, v in sorted(acc.plain.items())},
        "collectives": {
            k: {"count": e["count"], "payload_bytes": int(e["payload_bytes"]),
                "axis_size": e["axis_size"], "cost_us": round(e["cost_s"] * 1e6, 3)}
            for k, e in sorted(acc.collectives.items())},
        "predicted": _roofline(acc),
    }


_WALK = {"pricer": None}


def walk(thunk: Callable[[], object], observers=(), plain: bool = True) -> tuple[object, "Costs"]:
    """Run ``thunk()`` once under the pricing mode on the card's route, with
    ``observers`` watching (see :class:`_Pricer`); (its result, its costs).
    ``plain=False`` skips walking the plain versions beside their kernels
    (their costs are then not in the ``plain`` rows).  The perf, trace and
    shard planes all walk through here."""
    import torch

    pricer = _Pricer(observers, plain)
    _WALK["pricer"] = pricer
    try:
        with torch.no_grad(), card_route(), _kernels_stood_in(pricer), pricer.mode:
            out = thunk()
    finally:
        _WALK["pricer"] = None
    return out, pricer.stack[0]


def estimate_callable(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` (meta tensors, or a thunk building them
    when called with no arguments) once under the pricing mode on the
    card's route and return its facts."""
    return _facts(walk(lambda: fn(*args, **kwargs))[1])


# --------------------------------------------------------- recording mesh ----


@dataclass(frozen=True)
class RecordingMesh:
    """A stand-in for ``utils/mesh.Mesh`` that exists only in the walk:
    axis names and sizes, one rank's coordinates, and collectives that
    record into the census and return tensors of the shapes a real mesh
    would.  A model built on it (``device="meta"``) holds that rank's
    slices, as on a real mesh."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int = 0
    stats: dict = field(default_factory=dict, compare=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    @property
    def wait_s(self) -> float:
        return 0.0

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's index on ``axis`` (row-major, the last axis fastest,
        as ``Mesh.coords``)."""
        r = self.rank
        for name, n in reversed(list(self.shape.items())):
            if name == axis:
                return r % n
            r //= n
        return 0

    def _record(self, op: str, axis: str, payload: int) -> None:
        pricer = _WALK["pricer"]
        if pricer is not None:
            n = self.size if axis == "world" else self.axis_size(axis)
            pricer.stack[-1].add_collective(op, axis, n, payload)

    def ring_shift(self, tensors, axis: str):
        for t in tensors:
            self._record("ppermute", axis, _nbytes(t))
        return [t.clone() for t in tensors]

    def all_reduce(self, t, axis: str):
        self._record("all_reduce", axis, _nbytes(t))
        return t.clone()

    def all_gather(self, t, axis: str, dim: int = -1):
        import torch

        self._record("all_gather", axis, _nbytes(t))
        return torch.cat([t] * self.axis_size(axis), dim=dim)

    def broadcast(self, t):
        """Rank 0's tensor on every rank (``Mesh.broadcast``), over the
        whole world."""
        self._record("broadcast", "world", _nbytes(t))
        return t

    def broadcast_object(self, obj=None):
        """Rank 0's object on every rank (``Mesh.broadcast_object``): its
        pickled bytes, which is what the world moves."""
        import pickle

        self._record("broadcast_object", "world", len(pickle.dumps(obj)))
        return obj


# -------------------------------------------------------------- registry ----


@dataclass
class Call:
    """One dispatch made: ``fn(*args, **kwargs)`` on meta operands, and the
    KV cache it writes in place (None for a call that writes none)."""

    fn: Callable
    args: tuple
    kwargs: dict
    cache: object = None

    def __call__(self):
        return self.fn(*self.args, **self.kwargs)


@dataclass
class Dispatch:
    """One declared dispatch signature: its label and ``make(base=None)``,
    which builds its :class:`Call` on meta operands (on ``base``, the
    entry's ``setup()``, when given; else on a fresh one)."""

    label: str
    make: Callable[..., Call]


@dataclass
class PerfEntry:
    """One registered entry point.  ``axes`` is the matrix of signatures the
    scheduler can produce and ``build(**values)`` one of them (None for a
    combination that cannot occur); ``representatives`` are the ones walked.
    ``signatures`` maps a representative's label to a thunk that builds its
    meta operands and runs it once: what the perf plane prices (given
    directly for an entry with no matrix).  The trace and shard planes read
    the same entries (``analysis/tracecheck.py``)."""

    name: str
    signatures: dict[str, Callable[[], object]] = field(default_factory=dict)
    axes: dict[str, list] = field(default_factory=dict)
    build: Optional[Callable[..., Optional[Dispatch]]] = None
    representatives: list[dict] = field(default_factory=list)
    setup: Optional[Callable[[], object]] = None
    # TR006's floor: a cast below this many elements is not counted
    upcast_min_elems: int = 0
    # the forward whose footprint TR007 holds against the card's memory
    footprint: bool = False

    def __post_init__(self):
        if self.build is not None and not self.signatures:
            for values in self.representatives:
                d = self.build(**values)
                self.signatures[d.label] = lambda d=d: d.make()()


def _pow2s_upto(n: int) -> list[int]:
    out, b = [], 1
    while b <= n:
        out.append(b)
        b *= 2
    return out


META = "meta"


def _i32(*shape):
    import torch

    return torch.zeros(shape, dtype=torch.int32, device=META)


def _f32(*shape):
    import torch

    return torch.zeros(shape, dtype=torch.float32, device=META)


def tiny_model_config():
    """The JAX perf and trace planes' tiny Llama (their tracecheck.py
    ``_tiny_model_config``)."""
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=256,
                       dtype="bfloat16")


def tiny_engine_config(**kw):
    from dynamo_tpu_torch.engine.config import EngineConfig

    base = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64,
                prefill_buckets=[16, 32, 64, 128])
    base.update(kw)
    return EngineConfig(**base)


def llama3_8b_config(num_layers: int = 32):
    """Llama-3-8B, the port's serving model (meta-llama/Meta-Llama-3-8B
    config.json)."""
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                       num_layers=num_layers, num_heads=32, num_kv_heads=8,
                       max_position_embeddings=8192, rope_theta=500000.0, dtype="bfloat16")


def tiny_deepseek_config():
    """The JAX trace, perf and shard planes' tiny absorbed-MLA DeepSeek."""
    from dynamo_tpu_torch.models.deepseek import DeepseekConfig

    return DeepseekConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                          qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, kv_lora_rank=16,
                          intermediate_size=64, moe_intermediate_size=32, n_routed_experts=4,
                          num_experts_per_tok=2, first_k_dense_replace=1, dtype="bfloat16")


def _llama(cfg):
    from dynamo_tpu_torch.models.llama import LlamaModel

    return LlamaModel(cfg, device=META)


def _sampling(rows: int) -> tuple:
    return (None, _f32(rows), _i32(rows), _f32(rows))


def _engine_entries(tag: str, model_cfg, cfg) -> list[PerfEntry]:
    """The step functions of ``engine/core.py::STEP_FNS`` (and the draft
    proposer) under one (model, engine) config, by JAX's entry names, axes
    and signature labels (its tracecheck.py ``_engine_entrypoints``), the
    JAX registry's representatives walked."""
    from dynamo_tpu_torch.engine import core as ec

    m, b, bs = cfg.max_blocks_per_seq, cfg.max_batch_size, cfg.block_size
    pb_axis = [0] + _pow2s_upto(m)
    cache_dtype = cfg.cache_dtype or model_cfg.dtype
    hidden = model_cfg.hidden_size

    def setup():
        model = _llama(model_cfg)
        return model, model.init_kv_cache(cfg.num_blocks, bs, cache_dtype)

    def entry(name, axes, build, reps):
        return PerfEntry(f"{name}[{tag}]", axes=axes, build=build, representatives=reps,
                         setup=setup, upcast_min_elems=hidden)

    def step(s_bucket, prefix_blocks):
        def make(base=None):
            model, cache = base or setup()
            s = s_bucket
            return Call(ec.unified_step, (model, cache, _i32(1, s), _i32(1, s), _i32(1, m), _i32(1),
                                          _i32(1, s), _i32(1), *_sampling(1)),
                        dict(prefix_blocks=prefix_blocks), cache)
        return Dispatch(f"s={s_bucket},pb={prefix_blocks}", make)

    buckets = list(cfg.prefill_buckets)
    entries = [entry("engine.step", {"s_bucket": buckets, "prefix_blocks": pb_axis}, step,
                     [dict(s_bucket=buckets[-1], prefix_blocks=0),
                      dict(s_bucket=buckets[0], prefix_blocks=pb_axis[-1])])]

    # the burst lengths the default path dispatches: the interactive and the full burst
    bursts = sorted({cfg.interactive_decode_steps, max(1, cfg.decode_steps)})

    def multi(num_steps):
        def make(base=None):
            model, cache = base or setup()
            return Call(ec.multi_decode_step, (model, cache, _i32(b), _i32(b), _i32(b, m), _i32(b),
                                               _i32(b), *_sampling(b)),
                        dict(num_steps=num_steps, block_size=bs), cache)
        return Dispatch(f"k={num_steps}", make)

    entries.append(entry("engine.decode_multi", {"num_steps": bursts}, multi,
                         [dict(num_steps=bursts[-1])]))

    if cfg.spec_tokens > 0:
        s = cfg.spec_tokens + 1

        def spec(m_used):
            def make(base=None):
                model, cache = base or setup()
                return Call(ec.spec_verify_step, (model, cache, _i32(b, s), _i32(b, s),
                                                  _i32(b, m_used), _i32(b), _i32(b, s),
                                                  *_sampling(b)), {}, cache)
            return Dispatch(f"m_used={m_used}", make)

        entries.append(entry("engine.spec_verify", {"m_used": _pow2s_upto(m)}, spec,
                             [dict(m_used=_pow2s_upto(m)[-1])]))

    r_all = _pow2s_upto(1 << max(0, (b - 1).bit_length()))
    if cfg.prefill_token_budget > 0:
        t_axis = [x for x in cfg.prefill_buckets if x <= cfg.bucket_for(cfg.prefill_token_budget)]

        def ragged(t_bucket, r_pad, prefix_blocks):
            # pow2ceil(r_real) == r_pad needs r_real > r_pad/2 rows, each at
            # least one block wide on the flat axis
            min_rows = r_pad // 2 + 1 if r_pad > 1 else 1
            if min_rows * bs > t_bucket:
                return None
            t, r = t_bucket, r_pad

            def make(base=None):
                model, cache = base or setup()
                return Call(ec.ragged_prefill_step,
                            (model, cache, _i32(1, t), _i32(1, t), _i32(r, m), _i32(r), _i32(1, t),
                             _i32(1, t), _i32(r), _i32(r), _i32(r), *_sampling(r)),
                            dict(prefix_blocks=prefix_blocks), cache)
            return Dispatch(f"t={t},r={r},pb={prefix_blocks}", make)

        entries.append(entry("engine.prefill_ragged",
                             {"t_bucket": t_axis, "r_pad": r_all, "prefix_blocks": pb_axis}, ragged,
                             [dict(t_bucket=t_axis[-1], r_pad=r_all[-1], prefix_blocks=0)]))

        if cfg.unified_token_dispatch or cfg.lookahead_dispatch:
            # engine _run_unified's flat-axis math: a static decode region
            # leads the axis, prefill spans pack the remainder
            d_region = -(-b // bs) * bs
            pf = min(max(bs, cfg.prefill_token_budget - d_region), cfg.max_model_len - d_region)
            tu_axis = [x for x in cfg.prefill_buckets
                       if cfg.bucket_for(d_region + bs) <= x <= cfg.bucket_for(d_region + pf)]
            ru_axis = [x for x in r_all if x >= 2]  # a mixed dispatch has >= 2 rows

            def mixed(t_bucket, r_pad):
                # pow2ceil(r_real) == r_pad needs more rows than the slots
                # can supply, or no block-wide span fits past the region
                min_rows = r_pad // 2 + 1 if r_pad > 1 else 1
                return min_rows <= b and (t_bucket - d_region) // bs >= 1

            def unified(t_bucket, r_pad, prefix_blocks):
                if not mixed(t_bucket, r_pad):
                    return None
                t, r = t_bucket, r_pad

                def make(base=None):
                    model, cache = base or setup()
                    return Call(ec.unified_token_step,
                                (model, cache, _i32(1, t), _i32(1, t), _i32(r, m), _i32(r),
                                 _i32(1, t), _i32(1, t), _i32(r), _i32(r), _i32(r), *_sampling(r)),
                                dict(row_tokens=d_region, prefix_blocks=prefix_blocks), cache)
                return Dispatch(f"t={t},r={r},pb={prefix_blocks}", make)

            axes = {"t_bucket": tu_axis, "r_pad": ru_axis, "prefix_blocks": pb_axis}
            entries.append(entry("engine.unified", axes, unified,
                                 [dict(t_bucket=tu_axis[-1], r_pad=ru_axis[-1], prefix_blocks=0)]))

            if cfg.lookahead_dispatch and cfg.interactive_decode_steps >= 2:
                # the fused burst: the unified step's axes, the per-row limits
                # operand and one burst depth (the interactive burst length,
                # the only depth _run_unified dispatches)
                kb = cfg.interactive_decode_steps

                def burst(t_bucket, r_pad, prefix_blocks, num_steps):
                    if not mixed(t_bucket, r_pad):
                        return None
                    t, r = t_bucket, r_pad

                    def make(base=None):
                        model, cache = base or setup()
                        return Call(ec.unified_burst_step,
                                    (model, cache, _i32(1, t), _i32(1, t), _i32(r, m), _i32(r),
                                     _i32(1, t), _i32(1, t), _i32(r), _i32(r), _i32(r), _i32(r),
                                     *_sampling(r)),
                                    dict(num_steps=num_steps, block_size=bs, row_tokens=d_region,
                                         prefix_blocks=prefix_blocks), cache)
                    return Dispatch(f"t={t},r={r},pb={prefix_blocks},k={num_steps}", make)

                entries.append(entry("engine.unified_burst", dict(axes, num_steps=[kb]), burst,
                                     [dict(t_bucket=tu_axis[-1], r_pad=ru_axis[-1],
                                           prefix_blocks=0, num_steps=kb)]))

    if cfg.spec_tokens > 0:
        def draft_setup():
            from dynamo_tpu_torch.engine.draft import DraftProposer

            return DraftProposer(_llama(model_cfg), cfg)

        def draft(u, m_used, k):
            def make(base=None):
                import torch

                proposer = base or draft_setup()
                return Call(proposer._impl, (_i32(b, u), _i32(b, u), _i32(b, m_used), _i32(b),
                                             _i32(b, u), _i32(b),
                                             torch.zeros(b, dtype=torch.bool, device=META), k),
                            {}, proposer.cache)
            return Dispatch(f"u={u},m={m_used},k={k}", make)

        entries.append(PerfEntry(
            f"engine.draft_propose[{tag}]",
            axes={"u": _pow2s_upto(16), "m_used": _pow2s_upto(m), "k": sorted({1, cfg.spec_tokens})},
            build=draft, representatives=[dict(u=4, m_used=_pow2s_upto(m)[-1], k=cfg.spec_tokens)],
            setup=draft_setup, upcast_min_elems=hidden))
    return entries


def _llama_forward_entry(tag: str, model_cfg, *, num_blocks: int, block_size: int, batch: int,
                         max_model_len: int, prefill_tokens: int,
                         footprint: bool = False) -> PerfEntry:
    """The model forward, decode ([batch, 1]) and prefill ([1,
    prefill_tokens] from 0)."""
    m = -(-max_model_len // block_size)

    def setup():
        model = _llama(model_cfg)
        return model, model.init_kv_cache(num_blocks, block_size)

    def build(phase):
        b, s, pb = (batch, 1, None) if phase == "decode" else (1, prefill_tokens, 0)

        def make(base=None):
            model, cache = base or setup()
            return Call(model.forward, (_i32(b, s), _i32(b, s), cache, _i32(b, m), _i32(b),
                                        _i32(b, s)), dict(prefix_blocks=pb), cache)
        return Dispatch(phase, make)

    return PerfEntry(f"models.llama.forward[{tag}]", axes={"phase": ["decode", "prefill"]},
                     build=build, representatives=[dict(phase="decode"), dict(phase="prefill")],
                     setup=setup, upcast_min_elems=model_cfg.hidden_size, footprint=footprint)


def _deepseek_forward_entry() -> PerfEntry:
    """The JAX registry's tiny absorbed-MLA DeepSeek forward."""
    from dynamo_tpu_torch.models.deepseek import DeepseekModel

    cfg = tiny_deepseek_config()
    m, b = 8, 2

    def setup():
        model = DeepseekModel(cfg, device=META)
        return model, model.init_kv_cache(16, 8)

    def build(phase):
        bb, s = (b, 1) if phase == "decode" else (1, 16)

        def make(base=None):
            model, cache = base or setup()
            return Call(model.forward, (_i32(bb, s), _i32(bb, s), cache, _i32(bb, m), _i32(bb),
                                        _i32(bb, s)), {}, cache)
        return Dispatch(phase, make)

    return PerfEntry("models.deepseek.forward[tiny-mla]", axes={"phase": ["decode", "prefill"]},
                     build=build, representatives=[dict(phase="decode"), dict(phase="prefill")],
                     setup=setup, upcast_min_elems=cfg.hidden_size)


def _ops_entries(model_cfg, cfg) -> list[PerfEntry]:
    """The serving ops by themselves, at the tiny Llama's engine shapes."""
    import torch

    from dynamo_tpu_torch.ops import block_copy
    from dynamo_tpu_torch.ops import paged_attention as pa

    m, b = cfg.max_blocks_per_seq, cfg.max_batch_size
    h, d, hk = model_cfg.num_heads, model_cfg.head_dim, model_cfg.num_kv_heads

    def cache():
        return _llama(model_cfg).init_kv_cache(cfg.num_blocks, cfg.block_size)

    def bf16(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=META)

    def decode(s):
        def make(base=None):
            return Call(pa.paged_attention_layer, (bf16(b, s, h, d), cache() if base is None else base, 0,
                                                   _i32(b, m), _i32(b), _i32(b, s)), {})
        return Dispatch(f"s={s}", make)

    def ragged(t, r):
        def make(base=None):
            return Call(pa.ragged_prefill_attention,
                        (bf16(1, t, h, d), bf16(1, t, hk, d), bf16(1, t, hk, d), cache() if base is None else base, 0,
                         _i32(r, m), _i32(r), _i32(r), _i32(r), _i32(1, t), 2), {})
        return Dispatch(f"t={t},r={r}", make)

    def scatter(n):
        def make(base=None):
            blocks = bf16(model_cfg.num_layers, n, 2, cfg.block_size, hk * d)
            c = cache() if base is None else base
            return Call(block_copy.scatter_blocks_inplace, (c, _i32(n), blocks), {}, c)
        return Dispatch(f"n={n}", make)

    # the multi-query verify's S = 3 beside the decode step's S = 1
    return [PerfEntry("ops.paged_attention_layer[tiny-llama]", axes={"s": [1, 3]}, build=decode,
                      representatives=[dict(s=1)], setup=cache, upcast_min_elems=hk * d),
            PerfEntry("ops.ragged_prefill_attention[tiny-llama]", axes={"t": [32, 64], "r": [2]},
                      build=ragged, representatives=[dict(t=64, r=2)], setup=cache,
                      upcast_min_elems=hk * d),
            PerfEntry("ops.scatter_blocks_inplace[tiny-llama]", axes={"n": _pow2s_upto(8)},
                      build=scatter, representatives=[dict(n=4)], setup=cache)]


def _ring_attention_entry(axis_size: int = 4) -> PerfEntry:
    """One rank's ring attention over a 4-rank sequence axis (JAX's
    shard_map body at its global S = 128), its ring shifts through the
    recording mesh."""
    import torch

    from dynamo_tpu_torch.ops.ring_attention import ring_attention_inner
    from dynamo_tpu_torch.utils.mesh import AXIS_SP

    h, hk, d = 4, 2, 8

    def build(s):
        c = s // axis_size

        def make(base=None):
            bf16 = dict(dtype=torch.bfloat16, device=META)
            mesh = RecordingMesh((AXIS_SP,), (axis_size,))
            return Call(ring_attention_inner, (
                torch.zeros((1, c, h, d), **bf16), torch.zeros((1, c, hk, d), **bf16),
                torch.zeros((1, c, hk, d), **bf16), _i32(1, c), _i32(1, c), mesh, AXIS_SP), {})
        return Dispatch(f"s={s}", make)

    return PerfEntry(f"ops.ring_attention[sp{axis_size}]", axes={"s": [128]}, build=build,
                     representatives=[dict(s=128)], upcast_min_elems=hk * d)


def _mlp_reference_entry() -> PerfEntry:
    """The gated MLP of Llama-3-8B over 8,192 tokens, priced alone: the
    compute-bound share of a real prefill, which keeps a compute-bound row
    in the manifest."""
    import torch

    hidden, inter = 4096, 14336

    def build(t):
        def make(base=None):
            bf16 = dict(dtype=torch.bfloat16, device=META)
            x = torch.zeros((t, hidden), **bf16)
            wg, wu = torch.zeros((hidden, inter), **bf16), torch.zeros((hidden, inter), **bf16)
            wd = torch.zeros((inter, hidden), **bf16)
            return Call(lambda: (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd, (), {})
        return Dispatch(f"t={t}", make)

    return PerfEntry("roofline.mlp_reference[llama3-8b-h100]", axes={"t": [8192]}, build=build,
                     representatives=[dict(t=8192)], upcast_min_elems=hidden)


# the serving shapes of the full-width forward: chip_smoke.py's default
# path (8 slots, a 2,048-token table of 16-slot blocks) and its longest
# prompt's prefill (1,500 tokens in a 1,504-token dispatch)
LLAMA3_8B_SHAPES = dict(num_blocks=1024, block_size=16, batch=8, max_model_len=2048,
                        prefill_tokens=1504)


def build_perf_registry() -> list[PerfEntry]:
    """The one registry of entry points, which the perf, trace and shard
    planes read: JAX's 17 trace entries under the port's names (the step
    functions at the tiny configs, the model forwards with Llama-3-8B, the
    port's serving model, in place of JAX's llama3b-v5e, the serving ops),
    and JAX's two perf extras (ring attention over a 4-rank axis, the MLP
    reference)."""
    tiny = tiny_model_config()
    entries = _engine_entries("tiny-llama", tiny, tiny_engine_config(
        decode_steps=16, spec_tokens=2, prefill_token_budget=64, lookahead_dispatch=True))
    entries += _engine_entries("tiny-llama-int8", tiny, tiny_engine_config(
        cache_dtype="int8", prefill_token_budget=64, unified_token_dispatch=True))
    entries.append(_llama_forward_entry("tiny-llama", tiny, num_blocks=64, block_size=8, batch=4,
                                        max_model_len=128, prefill_tokens=128))
    entries.append(_deepseek_forward_entry())
    entries.append(_llama_forward_entry("llama3-8b-h100", llama3_8b_config(), **LLAMA3_8B_SHAPES,
                                        footprint=True))
    entries += _ops_entries(tiny, tiny_engine_config())
    entries.append(_ring_attention_entry())
    entries.append(_mlp_reference_entry())
    return entries


def collect_perf_facts(registry: Optional[list[PerfEntry]] = None) -> dict:
    """Roofline facts for every registered entry point, per signature."""
    registry = registry if registry is not None else build_perf_registry()
    return {e.name: {"signatures": {label: estimate_callable(thunk)
                                    for label, thunk in e.signatures.items()}}
            for e in registry}


# ---------------------------------------------------------------- check ----


def check_perf_facts(facts: dict, manifest: PerfManifest) -> list[PerfFinding]:
    """Drift vs the committed snapshot (PF001/PF003/PF004, with tolerance
    bands) plus the intrinsic collective census (PF002, count-keyed)."""
    findings: list[PerfFinding] = []
    known = manifest.entrypoints
    committed_ver = (manifest.header or {}).get("constants_version")
    if known and committed_ver != topology.CONSTANTS_VERSION:
        findings.append(PerfFinding(
            "(topology)", "PF001", "constants",
            f"topology constants version drifted: manifest pins {committed_ver!r}, obs.topology "
            f"has {topology.CONSTANTS_VERSION!r}: every predicted latency moved; review the "
            "constants change and re-snapshot (`lint --perf --update-baseline`)"))
    for name in sorted(set(facts) - set(known)):
        findings.append(PerfFinding(
            name, "PF001", "added",
            "entry point has no committed roofline baseline: audit the prediction and "
            "re-snapshot (`lint --perf --update-baseline`)"))
    for name in sorted(set(known) - set(facts)):
        findings.append(PerfFinding(
            name, "PF001", "removed",
            "manifest entry point no longer registered: re-snapshot if the removal is intended"))
    for name, f in sorted(facts.items()):
        old_sigs = (known.get(name) or {}).get("signatures", {})
        for label, est in sorted(f.get("signatures", {}).items()):
            for ckey, c in est.get("collectives", {}).items():
                findings.append(PerfFinding(
                    name, "PF002", f"{label}:{ckey}x{c['count']}",
                    f"{c['count']} {ckey} collective(s) over {c['axis_size']} cards moving "
                    f"{c['payload_bytes']:,} B (+{c['cost_us']:.1f} us predicted): accept with a "
                    "justification only if the collective is by design on this dispatch"))
            old = old_sigs.get(label)
            if old is None:
                if known and name in known:
                    findings.append(PerfFinding(
                        name, "PF001", f"{label}:added",
                        "signature has no committed roofline baseline: re-snapshot"))
                continue
            new_ms, old_ms = est["predicted"]["total_ms"], old["predicted"]["total_ms"]
            if old_ms > 0 and new_ms > old_ms * (1 + LATENCY_REL_TOL):
                p = est["predicted"]
                findings.append(PerfFinding(
                    name, "PF001", label,
                    f"predicted step latency regressed {old_ms:.4f} -> {new_ms:.4f} ms "
                    f"(+{(new_ms / old_ms - 1) * 100:.1f}%, tolerance {LATENCY_REL_TOL * 100:.0f}%): "
                    f"compute {p['compute_ms']:.4f} ms, memory {p['memory_ms']:.4f} ms, collectives "
                    f"{p['collective_ms']:.4f} ms: fix the hot path or justify via --update-baseline"))
            old_int, new_int = old["intensity"], est["intensity"]
            if old["predicted"]["bound"] == "compute" and old_int > 0 and \
                    new_int < old_int * (1 - INTENSITY_REL_TOL):
                findings.append(PerfFinding(
                    name, "PF003", label,
                    f"arithmetic intensity dropped {old_int:.2f} -> {new_int:.2f} FLOP/B on a "
                    "compute-bound entry point: bytes grew faster than FLOPs (a layout copy or an "
                    "upcast on the hot path)"))
            if old["predicted"]["bound"] == "bandwidth" and old["bytes"] > 0 and \
                    est["bytes"] > old["bytes"] * (1 + BYTES_REL_TOL):
                findings.append(PerfFinding(
                    name, "PF004", label,
                    f"modeled HBM traffic grew {old['bytes']:,} -> {est['bytes']:,} B "
                    f"(+{(est['bytes'] / old['bytes'] - 1) * 100:.1f}%) on a bandwidth-bound entry "
                    "point: bytes are its latency on this side of the roofline"))
    return sorted(findings)


def _perf_header() -> dict:
    return {
        "note": _MANIFEST_NOTE,
        "topology": topology.DEFAULT_TOPOLOGY,
        "constants_version": topology.CONSTANTS_VERSION,
        "collective_link": COLLECTIVE_LINK,
        "tolerances": {"latency_rel": LATENCY_REL_TOL, "intensity_rel": INTENSITY_REL_TOL,
                       "bytes_rel": BYTES_REL_TOL},
    }


# ----------------------------------------------------------- predictions ----

def manifest_predictions(path: Optional[Path] = None) -> list[dict]:
    """Flat predicted-latency rows from the committed manifest (a JSON
    read, nothing priced): what ``/metrics`` renders as
    ``dynamo_tpu_perf_predicted_step_ms{entrypoint,config,signature,bound}``."""
    p = Path(path) if path is not None else DEFAULT_PERF_MANIFEST_PATH
    rows: list[dict] = []
    if p.is_file():
        try:
            doc = json.loads(p.read_text())
        except (OSError, ValueError):
            doc = {}
        for name, f in sorted(doc.get("entrypoints", {}).items()):
            base, _, cfg = name.partition("[")
            for label, est in sorted(f.get("signatures", {}).items()):
                rows.append({"entrypoint": base, "config": cfg.rstrip("]"), "signature": label,
                             "predicted_ms": est["predicted"]["total_ms"],
                             "bound": est["predicted"]["bound"]})
    return rows


# ------------------------------------------------------------------- CLI ----


def run_perf(args, out) -> int:
    """``python -m dynamo_tpu_torch lint --perf``: text or stable JSON, exit
    1 on any non-accepted finding; ``--update-baseline`` re-snapshots the
    manifest (carrying justifications by key) and pins the topology
    constants version in its header."""
    manifest_path = Path(getattr(args, "manifest", None) or DEFAULT_PERF_MANIFEST_PATH)
    manifest = PerfManifest.load(manifest_path)
    facts = collect_perf_facts(build_perf_registry())
    findings = check_perf_facts(facts, manifest)
    if getattr(args, "update_baseline", False):
        intrinsic = [f for f in findings if f.rule == "PF002"]
        m = PerfManifest.from_facts(facts, intrinsic, manifest)
        m.header = _perf_header()
        m.save(manifest_path)
        print(f"perf manifest updated: {len(facts)} entrypoints, {len(intrinsic)} accepted finding"
              f"{'' if len(intrinsic) == 1 else 's'} -> {manifest_path}", file=out)
        return 0
    fresh = manifest.filter(findings)
    n_accepted = len(findings) - len(fresh)
    if getattr(args, "fmt", "text") == "json":
        doc = {"findings": [f.to_json() for f in fresh], "accepted": n_accepted,
               "total": len(findings), "entrypoints": sorted(facts)}
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        for f in fresh:
            print(f.render(), file=out)
        print(f"{len(fresh)} perf finding{'s' if len(fresh) != 1 else ''} ({n_accepted} accepted) "
              f"over {len(facts)} entrypoints", file=out)
    return 1 if fresh else 0
